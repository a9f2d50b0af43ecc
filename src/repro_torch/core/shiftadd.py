"""The QeiHaN shift-add dot product — paper Eq. 5 — and the quantized
projection layer built on it.

Port of ``src/repro/core/shiftadd.py``.  An activation quantizes to
``s * 2^e`` (``core.logquant``), a weight to int8 ``w`` (``core.wquant``),
and the D&S unit produces ``w << e`` for ``e >= 0`` and the truncating
arithmetic shift ``floor(w / 2^|e|)`` for ``e < 0``: the low bits never
leave memory.  :func:`shiftadd_matmul_bitplane` is the bit-plane regrouping
``y = sum_b sgn_b * (a_b @ plane_b)`` with ``a_b = s * 2^(b + e)`` where
``b + e >= 0``; it is the plain version of the CUDA plane-skipping kernel
(``kernels/bitplane_matmul``) and is used as nothing else.

:func:`quantized_linear_apply` is the projection every quantized GEMM of
the model runs: scale the activation, LOG2-quantize it and run the
plane-skipping bit-plane GEMM in one CUDA kernel
(``kernels/bitplane_matmul``, which applies the quantizer of
``kernels/log2quant`` in its prologue), then rescale by the per-channel
weight scale.  On CPU tensors the kernel's wrapper runs its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Union

import torch

from repro_torch.core import bitplane as bp
from repro_torch.core.logquant import LogQuantized, zero_sentinel
from repro_torch.core.wquant import quantize_weights

__all__ = ["shiftadd_matmul_bitplane", "QuantizedLinearParams", "QuantCtx",
           "as_quant_ctx", "quantized_linear_init", "quantized_linear_apply"]


def shiftadd_matmul_bitplane(q: LogQuantized, planes: torch.Tensor,
                             n_bits: int = 4) -> torch.Tensor:
    """``(M, K)`` codes x uint8 ``(bits, K, N)`` planes -> int32 ``(M, N)``.

    Each plane product runs in float64: ``a_b`` holds signed powers of two
    and the planes ``{0,1}``, so every partial sum is an integer far below
    2^53 and the float64 product is exact in any summation order (CUDA has
    no int32 matmul).  The total wraps to int32 like the reference's int32
    accumulator.
    """
    bits = planes.shape[0]
    e = q.exp.to(torch.int32)
    s = q.sign.to(torch.int32)
    alive = e != zero_sentinel(n_bits)
    out = None
    for b in range(bits):
        sh = b + e
        a_b = torch.where(alive & (sh >= 0), s << torch.clamp(sh, min=0), 0)
        term = torch.matmul(a_b.double(), planes[b].double())
        if b == bits - 1:
            term = -term                      # two's-complement sign plane
        out = term if out is None else out + term
    return out.to(torch.int64).to(torch.int32)


class QuantizedLinearParams(NamedTuple):
    planes: torch.Tensor      # uint8 (8, K, N) bit-planes (or packed along K)
    w_scale: torch.Tensor     # f32 per-output-channel scale (1, N)
    act_scale: torch.Tensor   # f32 scalar pre-scale
    bias: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class QuantCtx:
    """Runtime configuration of the quantized path, threaded to every
    ``dense``.

    * ``collect`` — when a list, each quantized projection appends
      ``(tile_fetched, tile_total, elem_fetched, elem_total)`` weight-plane
      traffic counts, weighted by the GEMM's N extent (tile-granular: what
      the kernel's skip rule reads; element-granular: the ASIC bank model).
    * ``capture`` — when a list, each quantized projection appends
      ``(xs, exp, sign, planes, y_int)``: the scaled activation, the codes
      the kernel's prologue wrote, the GEMM's planes (unpacked) and its
      int32 output, so a caller can hold the kernel's quantizer and GEMM
      against their plain versions on real activations.
    """

    n_bits: int = 4
    collect: Optional[List[tuple]] = None
    capture: Optional[List[tuple]] = None


def as_quant_ctx(quant: Union[bool, QuantCtx, None]) -> Optional[QuantCtx]:
    """False/None -> None (float path), True -> ``QuantCtx()``, a
    ``QuantCtx`` passes through."""
    if quant is None or quant is False:
        return None
    if isinstance(quant, QuantCtx):
        return quant
    if quant is True:
        return QuantCtx()
    raise TypeError(f"quant must be bool or QuantCtx, got {quant!r}")


def quantized_linear_init(w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          act_scale: Union[float, torch.Tensor] = 1.0,
                          bits: int = 8) -> QuantizedLinearParams:
    """Offline weight pre-arrangement: per-output-channel int8 + planes."""
    qw = quantize_weights(w, bits=bits, channel_axis=-1)
    return QuantizedLinearParams(
        planes=bp.to_bitplanes(qw.q, bits=bits),
        w_scale=qw.scale.reshape(1, -1),
        act_scale=torch.as_tensor(act_scale, dtype=torch.float32,
                                  device=w.device),
        bias=bias,
    )


def quantized_linear_apply(p: QuantizedLinearParams, x: torch.Tensor,
                           n_bits: int = 4,
                           ctx: Optional[QuantCtx] = None) -> torch.Tensor:
    """x (..., K) -> y (..., N) through the full QeiHaN path.

    One kernel call (``kernels.bitplane_matmul.log2_bitplane_matmul``)
    scales, LOG2-quantizes and runs the plane-skipping GEMM on the planes
    as stored, packed along K or not; on CPU tensors it runs its plain
    version.  The epilogue keeps the reference's float order:
    ``(y_int * w_scale) * act_scale``, then ``+ bias``.
    """
    from repro_torch.kernels.bitplane_matmul.ops import (
        log2_bitplane_matmul, plane_traffic_counts)

    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    want_codes = ctx is not None and (ctx.collect is not None
                                      or ctx.capture is not None)
    out = log2_bitplane_matmul(x2, p.act_scale, p.planes, n_bits=n_bits,
                               codes=want_codes)
    y_int, q = out if want_codes else (out, None)
    if ctx is not None and ctx.collect is not None:
        from repro_torch.core.access_model import needed_bits
        n_scale = float(p.planes.shape[-1])
        tile_f, tile_t = plane_traffic_counts(q.exp, n_bits=n_bits)
        nb = needed_bits(q.exp, n_bits=n_bits)
        alive = (q.exp != zero_sentinel(n_bits)).float()
        ctx.collect.append((tile_f * n_scale, tile_t * n_scale,
                            nb.float().sum() * n_scale,
                            alive.sum() * 8.0 * n_scale))
    if ctx is not None and ctx.capture is not None:
        planes = p.planes
        if planes.shape[1] * 8 == k:              # packed along K
            planes = bp.unpack_planes(planes, axis=0)
        ctx.capture.append((x2.float() / p.act_scale, q.exp, q.sign, planes,
                            y_int))
    y = y_int.float() * p.w_scale * p.act_scale
    y = y.reshape(*lead, -1)
    if p.bias is not None:
        y = y + p.bias
    return y
