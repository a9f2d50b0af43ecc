"""Wrapper for the CUDA LOG2 quantizer (``csrc/log2quant.cu``).

``log2quant(x, n_bits)`` returns ``LogQuantized(exp, sign)`` of ``x``'s
shape.  A CUDA tensor launches the kernel on the current stream (or
raises); a CPU tensor runs the plain version, ``core.logquant``'s
``log2_quantize``.  ``log2quant.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.logquant import LogQuantized, log2_quantize
from repro_torch.kernels import _build

_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lib():
    lib = _build.library("log2quant")
    if lib.qh_log2quant.argtypes is None:
        lib.qh_log2quant.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.qh_log2quant.restype = ctypes.c_int
        lib.qh_log2quant_error_string.argtypes = [ctypes.c_int]
        lib.qh_log2quant_error_string.restype = ctypes.c_char_p
    return lib


def log2quant(x: torch.Tensor, n_bits: int = 4) -> LogQuantized:
    if x.dtype not in _KINDS:
        raise TypeError(f"log2quant takes f32/bf16/f16, got {x.dtype}")
    if not 2 <= n_bits <= 8:
        raise ValueError(f"n_bits={n_bits} outside 2..8")
    if x.device.type == "cpu":
        return log2_quantize(x, n_bits)
    if x.device.type != "cuda":
        raise ValueError(f"log2quant runs on CUDA or CPU, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("log2quant needs a contiguous input")
    exp = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    sign = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        lib = _lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.qh_log2quant(x.data_ptr(), exp.data_ptr(), sign.data_ptr(),
                              x.numel(), _KINDS[x.dtype], n_bits, stream)
        if rc != 0:
            raise RuntimeError("log2quant launch failed: "
                               + lib.qh_log2quant_error_string(rc).decode())
        log2quant.launches += 1
    return LogQuantized(exp=exp, sign=sign)


log2quant.launches = 0
