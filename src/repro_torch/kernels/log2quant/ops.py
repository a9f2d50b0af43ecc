"""Wrapper for the CUDA LOG2 quantizer (``csrc/log2quant.cu``).

``log2quant_many(xs, n_bits)`` codes a list of tensors into one flat pair
of code buffers; ``log2quant(x, n_bits)`` is the one-entry list, returned
in ``x``'s shape.  CUDA tensors launch the kernel on the current stream
(or raise): one launch per ``MAX_ENTRIES`` entries of one dtype.  CPU
tensors run the plain version, ``core.logquant``'s ``log2_quantize``, into
the same layout.  ``log2quant.launches`` counts kernel launches of both.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.core.logquant import LogQuantized, log2_quantize
from repro_torch.kernels import _build

_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_ENTRIES = 128      # entries a launch takes (kMaxEntries in the source)


def _lib():
    lib = _build.library("log2quant")
    if lib.qh_log2quant_many.argtypes is None:
        lib.qh_log2quant_many.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.qh_log2quant_many.restype = ctypes.c_int
        lib.qh_log2quant_error_string.argtypes = [ctypes.c_int]
        lib.qh_log2quant_error_string.restype = ctypes.c_char_p
        lib.qh_log2quant_max_entries.restype = ctypes.c_int
        if lib.qh_log2quant_max_entries() != MAX_ENTRIES:
            raise RuntimeError("log2quant: the library takes "
                               f"{lib.qh_log2quant_max_entries()} entries "
                               f"a launch, the wrapper {MAX_ENTRIES}")
    return lib


def launch_plan(xs: Sequence[torch.Tensor]) -> List[List[Tuple[int, int]]]:
    """The launches that code ``xs``: each a list of ``(index, offset)``,
    ``offset`` being where entry ``index``'s codes start in the flat
    buffers.  Empty entries take no launch; the others go by dtype, in
    list order, at most ``MAX_ENTRIES`` a launch."""
    by_dtype = {}
    offset = 0
    for i, x in enumerate(xs):
        if x.numel():
            by_dtype.setdefault(x.dtype, []).append((i, offset))
        offset += x.numel()
    return [group[j:j + MAX_ENTRIES] for group in by_dtype.values()
            for j in range(0, len(group), MAX_ENTRIES)]


def log2quant_many(xs: Sequence[torch.Tensor], n_bits: int = 4
                   ) -> Tuple[LogQuantized, List[LogQuantized]]:
    """LOG2-code every tensor of ``xs`` (f32/bf16/f16, all on one device).

    Returns ``(flat, views)``: ``flat`` is a ``LogQuantized`` of two 1-D
    int8 tensors, ``sum(x.numel())`` long, holding the entries' codes in
    list order with no gaps (so it equals ``torch.cat`` of the views,
    flattened); ``views[i]`` is a ``LogQuantized`` of views into ``flat``
    in ``xs[i]``'s shape."""
    xs = list(xs)
    for x in xs:
        if x.dtype not in _KINDS:
            raise TypeError(f"log2quant takes f32/bf16/f16, got {x.dtype}")
    if not 2 <= n_bits <= 8:
        raise ValueError(f"n_bits={n_bits} outside 2..8")
    devices = {x.device for x in xs}
    if len(devices) > 1:
        raise ValueError(f"log2quant_many takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop() if devices else torch.device("cpu")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"log2quant runs on CUDA or CPU, not {dev}")
    if dev.type == "cuda" and not all(x.is_contiguous() for x in xs):
        raise ValueError("log2quant needs a contiguous input")
    total = sum(x.numel() for x in xs)
    exp = torch.empty(total, dtype=torch.int8, device=dev)
    sign = torch.empty(total, dtype=torch.int8, device=dev)
    views, o = [], 0
    for x in xs:
        views.append(LogQuantized(exp[o:o + x.numel()].view(x.shape),
                                  sign[o:o + x.numel()].view(x.shape)))
        o += x.numel()
    if dev.type == "cpu":
        for x, v in zip(xs, views):
            q = log2_quantize(x, n_bits)
            v.exp.copy_(q.exp)
            v.sign.copy_(q.sign)
        return LogQuantized(exp, sign), views
    plan = launch_plan(xs)
    if plan:
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
    for launch in plan:
        n = len(launch)
        ptrs = (ctypes.c_void_p * n)(*(xs[i].data_ptr() for i, _ in launch))
        ns = (ctypes.c_int64 * n)(*(xs[i].numel() for i, _ in launch))
        outs = (ctypes.c_int64 * n)(*(o for _, o in launch))
        rc = lib.qh_log2quant_many(ptrs, ns, outs, n, exp.data_ptr(),
                                   sign.data_ptr(),
                                   _KINDS[xs[launch[0][0]].dtype], n_bits,
                                   stream)
        if rc != 0:
            raise RuntimeError("log2quant launch failed: "
                               + lib.qh_log2quant_error_string(rc).decode())
        _build.count_launch(log2quant)
    return LogQuantized(exp, sign), views


def log2quant(x: torch.Tensor, n_bits: int = 4) -> LogQuantized:
    """``LogQuantized(exp, sign)`` of ``x``'s shape: ``log2quant_many`` of
    the one-entry list."""
    return log2quant_many([x], n_bits)[1][0]


log2quant.launches = 0
