"""Wrappers for the CUDA LOG2-quantize + plane-skipping bit-plane GEMM
(``csrc/bitplane_matmul.cu``), plus the plane-traffic accounting of its
skip rule.

``log2_bitplane_matmul(x, act_scale, planes, n_bits)``: f32/bf16 ``(M, K)``
activations, a device f32 scalar ``act_scale`` and uint8 planes in either
layout the model stores -- ``(8, K, N)`` {0,1} or packed along K
``(8, K/8, N)`` -- give int32 ``(M, N)``: the GEMM of the LOG2 codes of
``x / act_scale``, quantized in the kernel's prologue, in one launch.
With ``codes=True`` it also returns the codes (``LogQuantized``).

``bitplane_matmul(exp, sign, planes, n_bits)``: the same kernel fed the
codes themselves (its prologue skipped).

A CUDA tensor launches the kernel on the current stream (or raises); a CPU
tensor runs the plain version: ``core.logquant.log2_quantize``,
``core.bitplane.unpack_planes`` for packed planes, then
``core.shiftadd.shiftadd_matmul_bitplane``.  ``bitplane_matmul.launches``
counts the kernel's launches through either entry, one per call.

:func:`_skip_table`, :func:`plane_traffic_counts` and
:func:`plane_traffic_fraction` port ``src/repro/kernels/bitplane_matmul/
ops.py``: the 128 x 128 (m, k) tile geometry the kernel skips planes by.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.bitplane import unpack_planes
from repro_torch.core.logquant import (LogQuantized, log2_quantize,
                                       zero_sentinel)
from repro_torch.core.shiftadd import shiftadd_matmul_bitplane
from repro_torch.kernels import _build

WEIGHT_BITS = 8
# the kernel takes its tensor-core body (n_bits <= 4) from 128 rows and
# 128 x 384 outputs: below that its integer body is the faster on an H100
# (at 64 rows, and for the N = 192 projections at 128 rows on the
# unpacked planes the serving paths store; chip_smoke.py phase 5 times
# both bodies at 64, 128 and 256 rows)
TC_MIN_ROWS = 128
TC_MIN_OUTPUTS = 128 * 384


def tensor_core_body(m: int, n: int, n_bits: int) -> bool:
    """The body the wrapper takes for an (M, K) x (K, N) call."""
    return m >= TC_MIN_ROWS and m * n >= TC_MIN_OUTPUTS and n_bits <= 4
_INPUTS = {torch.float32: 0, torch.bfloat16: 1}
_CODES_INPUT = 2


def _lib():
    lib = _build.library("bitplane_matmul")
    if lib.qh_bitplane_matmul.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.qh_bitplane_matmul.argtypes = [
            ptr, i32, ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, i32, i32,
            i32, i32, ptr]
        lib.qh_bitplane_matmul.restype = ctypes.c_int
        # an empty kernel of a call's launch shape (chip_smoke.py phase 5)
        lib.qh_bitplane_matmul_launch_floor.argtypes = [i32] * 6 + [ptr]
        lib.qh_bitplane_matmul_launch_floor.restype = ctypes.c_int
        lib.qh_bitplane_matmul_error_string.argtypes = [ctypes.c_int]
        lib.qh_bitplane_matmul_error_string.restype = ctypes.c_char_p
    return lib


def is_packed(planes: torch.Tensor, k: int) -> bool:
    """True for planes packed along K ``(8, K/8, N)``, False for ``(8, K,
    N)``; raises on any other shape or type."""
    if planes.dtype != torch.uint8:
        raise TypeError(f"planes must be uint8, got {planes.dtype}")
    if planes.dim() == 3 and planes.shape[0] == WEIGHT_BITS:
        if planes.shape[1] == k:
            return False
        if k % 8 == 0 and planes.shape[1] * 8 == k:
            return True
    raise ValueError(f"planes must be ({WEIGHT_BITS}, K={k}, N) or packed "
                     f"({WEIGHT_BITS}, K/8, N), got {tuple(planes.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_call(m: int, n: int, device: torch.device, n_bits: int,
                out: Optional[torch.Tensor],
                tensor_cores: Optional[bool]) -> None:
    # sign * 2^exp * w stays inside int32 per product only up to 5 bits
    if not 2 <= n_bits <= 5:
        raise ValueError(f"n_bits={n_bits} outside 2..5")
    if tensor_cores and n_bits > 4:
        raise ValueError("the tensor-core body is exact only up to n_bits 4")
    if out is not None and (out.shape != (m, n) or out.dtype != torch.int32
                            or out.device != device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 ({m}, {n}) "
                         f"tensor on {device}")


def _launch(m: int, k: int, n: int, planes: torch.Tensor, packed: bool,
            n_bits: int, out: Optional[torch.Tensor],
            tensor_cores: Optional[bool], *, x=None, act_scale=None,
            exp=None, sign=None, codes: bool = False):
    device = planes.device
    if tensor_cores is None:
        tensor_cores = tensor_core_body(m, n, n_bits)
    if out is None:
        out = torch.empty((m, n), dtype=torch.int32, device=device)
    q = None
    if codes:
        q = LogQuantized(torch.empty((m, k), dtype=torch.int8, device=device),
                         torch.empty((m, k), dtype=torch.int8, device=device))
    if m and n:
        lib = _lib()
        stream = torch.cuda.current_stream(device).cuda_stream
        exp_out, sign_out = q if q is not None else (None, None)
        rc = lib.qh_bitplane_matmul(
            _ptr(x), _CODES_INPUT if x is None else _INPUTS[x.dtype],
            _ptr(act_scale), _ptr(exp), _ptr(sign), planes.data_ptr(),
            int(packed), out.data_ptr(), _ptr(exp_out), _ptr(sign_out), m,
            k, n, n_bits, int(tensor_cores), stream)
        if rc != 0:
            raise RuntimeError(
                "bitplane_matmul launch failed: "
                + lib.qh_bitplane_matmul_error_string(rc).decode())
        bitplane_matmul.launches += 1
    elif codes and m:
        raise ValueError("codes need at least one output column")
    return out, q


def log2_bitplane_matmul_plain(x: torch.Tensor, act_scale: torch.Tensor,
                               planes: torch.Tensor, n_bits: int = 4):
    """The plain version: ``(y int32 (M, N), LogQuantized)``."""
    q = log2_quantize(x.float() / act_scale, n_bits)
    if is_packed(planes, x.shape[1]):
        planes = unpack_planes(planes, axis=0)
    return shiftadd_matmul_bitplane(q, planes, n_bits=n_bits), q


def log2_bitplane_matmul(x: torch.Tensor, act_scale: torch.Tensor,
                         planes: torch.Tensor, n_bits: int = 4,
                         codes: bool = False,
                         out: Optional[torch.Tensor] = None,
                         tensor_cores: Optional[bool] = None,
                         ) -> Union[torch.Tensor,
                                    tuple[torch.Tensor, LogQuantized]]:
    """int32 GEMM of the LOG2 codes of ``x / act_scale`` with ``planes``.

    ``codes=True`` returns ``(y, LogQuantized(exp, sign))``.  ``out`` takes
    a preallocated int32 ``(M, N)`` output; ``tensor_cores`` forces one of
    the kernel's two bit-equal bodies (default: by M and n_bits).
    """
    if x.dtype not in _INPUTS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if (not isinstance(act_scale, torch.Tensor)
            or act_scale.dtype != torch.float32 or act_scale.numel() != 1):
        raise TypeError("act_scale must be a float32 scalar tensor")
    packed = is_packed(planes, x.shape[1])
    if not x.device == act_scale.device == planes.device:
        raise ValueError("x, act_scale and planes must share one device")
    _check_call(x.shape[0], planes.shape[2], x.device, n_bits, out,
                tensor_cores)
    if x.device.type == "cpu":
        y, q = log2_bitplane_matmul_plain(x, act_scale, planes, n_bits)
        if out is not None:
            out.copy_(y)
            y = out
        return (y, q) if codes else y
    if x.device.type != "cuda":
        raise ValueError(f"log2_bitplane_matmul runs on CUDA or CPU, not "
                         f"{x.device}")
    if not (x.is_contiguous() and planes.is_contiguous()):
        raise ValueError("log2_bitplane_matmul needs contiguous inputs")
    m, k = x.shape
    y, q = _launch(m, k, planes.shape[2], planes, packed, n_bits, out,
                   tensor_cores, x=x, act_scale=act_scale, codes=codes)
    return (y, q) if codes else y


def bitplane_matmul(exp: torch.Tensor, sign: torch.Tensor,
                    planes: torch.Tensor, n_bits: int = 4,
                    tensor_cores: Optional[bool] = None) -> torch.Tensor:
    """int32 GEMM of int8 ``(M, K)`` codes with ``planes`` (either
    layout): the same kernel with its quantizing prologue skipped."""
    if exp.dtype != torch.int8 or sign.dtype != torch.int8:
        raise TypeError("exp and sign must be int8")
    if exp.dim() != 2 or sign.shape != exp.shape:
        raise ValueError(f"exp/sign must be one (M, K) shape, got "
                         f"{tuple(exp.shape)} and {tuple(sign.shape)}")
    packed = is_packed(planes, exp.shape[1])
    if not exp.device == sign.device == planes.device:
        raise ValueError("exp, sign and planes must share one device")
    _check_call(exp.shape[0], planes.shape[2], exp.device, n_bits, None,
                tensor_cores)
    if exp.device.type == "cpu":
        if packed:
            planes = unpack_planes(planes, axis=0)
        return shiftadd_matmul_bitplane(LogQuantized(exp, sign), planes,
                                        n_bits=n_bits)
    if exp.device.type != "cuda":
        raise ValueError(f"bitplane_matmul runs on CUDA or CPU, not "
                         f"{exp.device}")
    if not (exp.is_contiguous() and sign.is_contiguous()
            and planes.is_contiguous()):
        raise ValueError("bitplane_matmul needs contiguous inputs")
    m, k = exp.shape
    y, _ = _launch(m, k, planes.shape[2], planes, packed, n_bits, None,
                   tensor_cores, exp=exp, sign=sign)
    return y


bitplane_matmul.launches = 0


def _skip_table(exp: torch.Tensor, block_m: int, block_k: int,
                n_bits: int, bits: int) -> torch.Tensor:
    """min_plane[mi, ki] = max(0, -max_exp_tile); ``bits`` if the tile is
    fully pruned.  ``exp`` is pre-padded to block multiples."""
    sentinel = zero_sentinel(n_bits)
    m, k = exp.shape
    e = exp.to(torch.int32).reshape(m // block_m, block_m,
                                    k // block_k, block_k).transpose(1, 2)
    alive = e != sentinel
    max_e = torch.where(alive, e, -128).amax(dim=(2, 3))
    min_plane = torch.clamp(-max_e, 0, bits)
    return torch.where(alive.any(dim=(2, 3)), min_plane, bits).to(torch.int32)


def plane_traffic_counts(exp: torch.Tensor, n_bits: int = 4,
                         block_m: int = 128, block_k: int = 128,
                         bits: int = WEIGHT_BITS):
    """(fetched, total) weight-plane tile counts as f32 scalars: ``total``
    is every plane of every (m-tile, k-tile) cell, ``fetched`` follows the
    kernel's skip rule (the same table)."""
    m, k = exp.shape
    pm, pk = (-m) % block_m, (-k) % block_k
    exp_p = F.pad(exp, (0, pk, 0, pm), value=zero_sentinel(n_bits))
    table = _skip_table(exp_p, block_m, block_k, n_bits, bits)
    fetched = (bits - table).sum().float()
    total = torch.full((), float(bits * table.numel()),
                       dtype=torch.float32, device=exp.device)
    return fetched, total


def plane_traffic_fraction(exp: torch.Tensor, n_bits: int = 4,
                           block_m: int = 128, block_k: int = 128,
                           bits: int = WEIGHT_BITS) -> torch.Tensor:
    """Fraction of weight-plane tiles the kernel actually reads (0..1)."""
    fetched, total = plane_traffic_counts(exp, n_bits, block_m, block_k, bits)
    return fetched / total
