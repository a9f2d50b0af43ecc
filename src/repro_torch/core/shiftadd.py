"""The QeiHaN shift-add dot product — paper Eq. 5 — and the quantized
projection layer built on it.

Port of ``src/repro/core/shiftadd.py``.  An activation quantizes to
``s * 2^e`` (``core.logquant``), a weight to int8 ``w`` (``core.wquant``),
and the D&S unit produces ``w << e`` for ``e >= 0`` and the truncating
arithmetic shift ``floor(w / 2^|e|)`` for ``e < 0``: the low bits never
leave memory.  :func:`shift_product` / :func:`shiftadd_matmul_elementwise`
are that per-element oracle (the specification);
:func:`shiftadd_matmul_bitplane` is the bit-plane regrouping
``y = sum_b sgn_b * (a_b @ plane_b)`` with ``a_b = s * 2^(b + e)`` where
``b + e >= 0``, the plain version of the CUDA plane-skipping kernel
(``kernels/bitplane_matmul``); :func:`shiftadd_matmul_exact` is the
untruncated float product the NaHiD (full-fetch) datapath computes.

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
from repro_torch.core.logquant import (LogQuantized, log2_dequantize,
                                      zero_sentinel)
from repro_torch.core.wquant import quantize_weights

__all__ = ["shift_product", "shiftadd_matmul_elementwise",
           "shiftadd_matmul_bitplane", "shiftadd_matmul_exact",
           "QuantizedLinearParams", "QuantCtx", "as_quant_ctx",
           "quantized_linear_init", "quantized_linear_apply",
           "calibrate_act_scale"]


def shift_product(w: torch.Tensor, q: LogQuantized,
                  n_bits: int = 4) -> torch.Tensor:
    """``sign * Bitshift(w, e)`` (int32) with an arithmetic right shift
    for ``e < 0``; the sentinel gives 0."""
    w32 = w.to(torch.int32)
    e = q.exp.to(torch.int32)
    shifted = torch.where(e >= 0, w32 << torch.clamp(e, min=0),
                          w32 >> torch.clamp(-e, min=0))
    shifted = torch.where(e == zero_sentinel(n_bits), 0, shifted)
    return q.sign.to(torch.int32) * shifted


def shiftadd_matmul_elementwise(q: LogQuantized, w: torch.Tensor,
                                n_bits: int = 4) -> torch.Tensor:
    """Oracle ``y[..., n] = sum_k s_k * Bitshift(w[k, n], e_k)`` for codes
    ``(..., K)`` and int8 ``w (K, N)``; builds ``(..., K, N)`` temporaries,
    so only for validation and small layers."""
    prod = shift_product(w.to(torch.int32)[None], LogQuantized(
        exp=q.exp[..., None], sign=q.sign[..., None]), n_bits)
    return prod.sum(dim=-2, dtype=torch.int32)


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


def shiftadd_matmul_exact(q: LogQuantized, w: torch.Tensor,
                          n_bits: int = 4) -> torch.Tensor:
    """Untruncated ``sum_k s_k w_k 2^{e_k}`` in float32 (NaHiD datapath)."""
    return torch.matmul(log2_dequantize(q, n_bits), w.float())


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


def calibrate_act_scale(x: torch.Tensor,
                        percentile: float = 99.9) -> torch.Tensor:
    """Per-tensor activation scale: the ``percentile`` magnitude of ``x``
    mapped to 2^3, i.e. ``max(p, 1e-12) / 8``.

    ``p`` is ``jnp.percentile``'s linear interpolation between sorted
    neighbours, on any size (``torch.quantile`` refuses more than 2^24
    elements).  The position ``percentile / 100 * (n - 1)`` is computed in
    float32 as XLA compiles it, ``percentile * float32((n - 1) * 0.01)``,
    so that large inputs take the reference's neighbours (past 2^24 the
    orders part by whole positions).  A NaN anywhere gives NaN, as there.
    """
    a = x.float().abs().reshape(-1)
    a = torch.where(torch.isnan(a).any(), float("nan"), a)
    a = torch.sort(a).values
    f32 = dict(dtype=torch.float32, device=a.device)
    span = torch.tensor(float(a.numel()), **f32) - 1
    pos = torch.tensor(percentile, **f32) * (
        span * torch.tensor(0.01, **f32))
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    last = a.numel() - 1
    lo_v = a[torch.clamp(low, 0, last).long()]
    hi_v = a[torch.clamp(high, 0, last).long()]
    mag = lo_v * low_w + hi_v * high_w
    return torch.clamp(mag, min=1e-12) / 8.0


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
                           ctx: Optional[QuantCtx] = None,
                           reduce: bool = False) -> torch.Tensor:
    """x (..., K) -> y (..., N) through the full QeiHaN path.

    One kernel call (``kernels.bitplane_matmul.log2_bitplane_matmul``)
    scales, LOG2-quantizes and runs the plane-skipping GEMM on the planes
    as stored, packed along K or not; on CPU tensors it runs its plain
    version.  The epilogue keeps the reference's float order:
    ``(y_int * w_scale) * act_scale``, then ``+ bias``.

    On a model axis (``models.sharding``) the planes may be a rank's
    shard.  Column-parallel planes hold the rank's run of the N output
    columns; the replicated per-channel ``w_scale`` is sliced to it.
    Row-parallel planes (``reduce=True``) hold the rank's run of K, ``x``
    its matching slice: the int32 partial is summed over the ranks before
    the float epilogue, so the result is the one-rank product exactly.
    The traffic counts scale by the local N; a projection every rank
    computes whole (replicated) is counted on rank 0 only, so that the
    ranks' counts sum to the one-rank counts.
    """
    from repro_torch.kernels.bitplane_matmul.ops import (
        log2_bitplane_matmul, plane_traffic_counts)
    from repro_torch.models import sharding as sh

    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    want_codes = ctx is not None and (ctx.collect is not None
                                      or ctx.capture is not None)
    out = log2_bitplane_matmul(x2, p.act_scale, p.planes, n_bits=n_bits,
                               codes=want_codes)
    y_int, q = out if want_codes else (out, None)
    n_local = p.planes.shape[-1]
    w_scale = p.w_scale
    if sh.cut_of(w_scale.shape[-1], n_local, "projection columns") > 1:
        w_scale = w_scale[..., sh.rank_slice(n_local)]
    if ctx is not None and ctx.collect is not None:
        from repro_torch.core.access_model import needed_bits
        n_scale = float(n_local)
        replicated = (not reduce and w_scale is p.w_scale
                      and sh.model_size() > 1)
        if replicated and sh.model_rank() != 0:
            n_scale = 0.0
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
    if reduce:
        y_int = sh.all_reduce(y_int)
    y = y_int.float() * w_scale * p.act_scale
    y = y.reshape(*lead, -1)
    if p.bias is not None:
        y = y + p.bias
    return y
