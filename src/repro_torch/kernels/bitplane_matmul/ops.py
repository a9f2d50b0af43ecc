"""Wrapper for the CUDA plane-skipping bit-plane GEMM
(``csrc/bitplane_matmul.cu``), plus the plane-traffic accounting of its
skip rule.

``bitplane_matmul(exp, sign, planes, n_bits)``: int8 ``(M, K)`` codes and
uint8 ``(8, K, N)`` {0,1} planes -> int32 ``(M, N)``.  A CUDA tensor
launches the kernel on the current stream (or raises); a CPU tensor runs
the plain version, ``core.shiftadd``'s ``shiftadd_matmul_bitplane``.
``bitplane_matmul.launches`` counts the wrapper's launches, one per call
(the GEMM kernel and, when K > 128, its pass that sums the K tiles).

:func:`_skip_table`, :func:`plane_traffic_counts` and
:func:`plane_traffic_fraction` port ``src/repro/kernels/bitplane_matmul/
ops.py``: the 128 x 128 (m, k) tile geometry the kernel skips planes by.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.logquant import LogQuantized, zero_sentinel
from repro_torch.core.shiftadd import shiftadd_matmul_bitplane
from repro_torch.kernels import _build

WEIGHT_BITS = 8
TILE_K = 128          # the kernel's K tile: one block per tile, split-K


def _lib():
    lib = _build.library("bitplane_matmul")
    if lib.qh_bitplane_matmul.argtypes is None:
        lib.qh_bitplane_matmul.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.qh_bitplane_matmul.restype = ctypes.c_int
        lib.qh_bitplane_matmul_error_string.argtypes = [ctypes.c_int]
        lib.qh_bitplane_matmul_error_string.restype = ctypes.c_char_p
    return lib


def bitplane_matmul(exp: torch.Tensor, sign: torch.Tensor,
                    planes: torch.Tensor, n_bits: int = 4) -> torch.Tensor:
    if exp.dtype != torch.int8 or sign.dtype != torch.int8:
        raise TypeError("exp and sign must be int8")
    if planes.dtype != torch.uint8:
        raise TypeError(f"planes must be uint8, got {planes.dtype}")
    if exp.dim() != 2 or sign.shape != exp.shape:
        raise ValueError(f"exp/sign must be one (M, K) shape, got "
                         f"{tuple(exp.shape)} and {tuple(sign.shape)}")
    if (planes.dim() != 3 or planes.shape[0] != WEIGHT_BITS
            or planes.shape[1] != exp.shape[1]):
        raise ValueError(f"planes must be ({WEIGHT_BITS}, K={exp.shape[1]}, "
                         f"N), got {tuple(planes.shape)}")
    # b + exp stays below 31 bits of shift only up to 5-bit exponents
    if not 2 <= n_bits <= 5:
        raise ValueError(f"n_bits={n_bits} outside 2..5")
    if not exp.device == sign.device == planes.device:
        raise ValueError("exp, sign and planes must share one device")
    if exp.device.type == "cpu":
        return shiftadd_matmul_bitplane(LogQuantized(exp, sign), planes,
                                        n_bits=n_bits)
    if exp.device.type != "cuda":
        raise ValueError(f"bitplane_matmul runs on CUDA or CPU, not "
                         f"{exp.device}")
    if not (exp.is_contiguous() and sign.is_contiguous()
            and planes.is_contiguous()):
        raise ValueError("bitplane_matmul needs contiguous inputs")
    m, k = exp.shape
    n = planes.shape[2]
    out = torch.empty((m, n), dtype=torch.int32, device=exp.device)
    if m and n:
        # one int32 (M, N) partial per K tile, summed by the kernel's
        # second pass
        k_tiles = -(-k // TILE_K)
        scratch = out if k_tiles <= 1 else torch.empty(
            (k_tiles, m, n), dtype=torch.int32, device=exp.device)
        lib = _lib()
        stream = torch.cuda.current_stream(exp.device).cuda_stream
        rc = lib.qh_bitplane_matmul(exp.data_ptr(), sign.data_ptr(),
                                    planes.data_ptr(), out.data_ptr(),
                                    scratch.data_ptr(), m, k, n, n_bits,
                                    stream)
        if rc != 0:
            raise RuntimeError(
                "bitplane_matmul launch failed: "
                + lib.qh_bitplane_matmul_error_string(rc).decode())
        bitplane_matmul.launches += 1
    return out


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
