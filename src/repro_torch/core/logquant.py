"""LOG2 activation quantization — QeiHaN paper Eqs. 2-4 (Fig. 5 comparator).

Port of ``src/repro/core/logquant.py``: the quantizer and its inverse, and
the page-level wire codes of the log2-quantized KV page pool, the direct
float cross-check :func:`log2_quantize_naive`, and the Fig. 2 / §VI-B
shares :func:`negative_fraction` and :func:`pruned_fraction`.
An activation ``x`` quantizes to ``sign * 2^exp`` with an ``n_bits``-bit
exponent in ``[-(2^(n-1)), 2^(n-1) - 1]``; the minimum code is the zero
sentinel (exact zeros, subnormals, NaN and everything whose rounded exponent
clips below the range are pruned to it).  Rounding is the paper's single
comparator, ``Round(log2|x|) = e + (m >= sqrt(2))`` on the IEEE-754 fields,
so the result is exact integer bit-twiddling for every input.

:func:`log2_quantize` is also the plain version of the CUDA quantizer
(``kernels/log2quant``), which computes the same function elementwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["LogQuantized", "zero_sentinel", "log2_quantize",
           "log2_quantize_naive", "log2_dequantize", "code_dtype",
           "pack_codes", "unpack_codes", "scale_exponent",
           "quantize_page_codes", "dequantize_page_codes",
           "negative_fraction", "pruned_fraction", "share"]

# First float32 mantissa field at or above sqrt(2): m >= sqrt(2) <=>
# M >= _SQRT2_M_F32 for m = 1 + M / 2^23 (floor((sqrt(2) - 1) * 2^23) + 1).
_SQRT2_M_F32 = 3474676


class LogQuantized(NamedTuple):
    """LOG2-quantized activations: ``value = sign * 2^exp`` (sentinel -> 0)."""

    exp: torch.Tensor   # int8 exponents in [-(2^(n-1)), 2^(n-1)-1]
    sign: torch.Tensor  # int8 in {-1, +1}


def zero_sentinel(n_bits: int = 4) -> int:
    """The exponent code that represents a pruned/zero activation."""
    return -(1 << (n_bits - 1))


def log2_quantize(x: torch.Tensor, n_bits: int = 4) -> LogQuantized:
    """Paper Eqs. 2-4 via the Fig. 5 comparator circuit.  Bit-exact.

    bf16/f16 inputs are cast to float32 first (an exact embedding).  The
    fields are read from the int32 view; the exponent field is masked after
    the shift, so the sign bit's arithmetic shift does no harm.
    """
    xf = x.float()
    bits = xf.view(torch.int32)
    exp_field = (bits >> 23) & 0xFF
    man_field = bits & 0x7FFFFF
    sentinel = zero_sentinel(n_bits)
    emax = (1 << (n_bits - 1)) - 1

    rounded = exp_field - 127 + (man_field >= _SQRT2_M_F32).to(torch.int32)
    is_subnormal_or_zero = exp_field == 0
    is_nonfinite = exp_field == 0xFF
    is_nan = is_nonfinite & (man_field != 0)

    e = torch.clamp(rounded, sentinel, emax)
    e = torch.where(is_subnormal_or_zero | is_nan, sentinel, e)
    e = torch.where(is_nonfinite & ~is_nan, emax, e)
    sign = torch.where(xf < 0, -1, 1).to(torch.int8)
    return LogQuantized(exp=e.to(torch.int8), sign=sign)


def log2_quantize_naive(x: torch.Tensor, n_bits: int = 4) -> LogQuantized:
    """Direct float evaluation of Eq. 3, ``floor(log2|x| + 0.5)`` (a
    cross-check only, not the specification: within float error of
    ``k + 1/2`` it may take the other code than the comparator)."""
    sentinel = zero_sentinel(n_bits)
    emax = (1 << (n_bits - 1)) - 1
    xf = x.float()
    absx = xf.abs()
    e = torch.clamp(torch.floor(torch.log2(absx) + 0.5), sentinel, emax)
    e = torch.where((absx == 0) | torch.isnan(xf), sentinel, e)
    sign = torch.where(xf < 0, -1, 1).to(torch.int8)
    return LogQuantized(exp=e.to(torch.int8), sign=sign)


def log2_dequantize(q: LogQuantized, n_bits: int = 4,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``sign * 2^exp`` with the sentinel decoding to exactly 0."""
    mag = torch.exp2(q.exp.float())
    val = q.sign.float() * mag
    return torch.where(q.exp == zero_sentinel(n_bits), 0.0, val).to(dtype)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2^e`` for int32 ``e`` in ``[-126, 127]``, built from
    the IEEE bits (no ``exp2`` rounding on any device)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def code_dtype(n_bits: int = 4) -> torch.dtype:
    """Container dtype of the packed wire code: ``code = exp*2 + sign``
    needs ``n_bits + 1`` bits, so int8 up to 7 exponent bits, int16 at 8."""
    return torch.int16 if n_bits >= 8 else torch.int8


def pack_codes(q: LogQuantized, n_bits: int = 4) -> torch.Tensor:
    """Pack (exp, sign) into one code: ``code = exp*2 + (sign<0)``."""
    ct = code_dtype(n_bits)
    return (q.exp.to(ct) << 1) | (q.sign < 0).to(ct)


def unpack_codes(codes: torch.Tensor, n_bits: int = 4) -> LogQuantized:
    """Inverse of :func:`pack_codes`; the arithmetic shift keeps the
    exponent's sign, and every width's exponent range fits int8."""
    exp = (codes >> 1).to(torch.int8)
    sign = torch.where((codes & 1) != 0, -1, 1).to(torch.int8)
    return LogQuantized(exp=exp, sign=sign)


def scale_exponent(x: torch.Tensor, dim=-1, keepdim: bool = False
                   ) -> torch.Tensor:
    """Power-of-two row scale ``floor(log2(max|x|))`` over ``dim`` (int32);
    zero and subnormal rows scale by 2^0.  A power-of-two scale makes the
    scaled quantize idempotent: requantizing a dequantized value under the
    same scale reproduces its code."""
    m = x.float().abs().amax(dim=dim, keepdim=keepdim)
    exp_field = (m.view(torch.int32) >> 23) & 0xFF
    return torch.where(exp_field == 0, 0, exp_field - 127).to(torch.int32)


def quantize_page_codes(x: torch.Tensor, scale_exp: torch.Tensor,
                        n_bits: int = 4) -> torch.Tensor:
    """LOG2-quantize ``x / 2^scale_exp`` and pack to wire codes.

    ``scale_exp`` (int32, at most 127 in magnitude) broadcasts against
    ``x``.  ``2^-scale_exp`` is applied as two exact powers of two (the
    reference multiplies by XLA's ``exp2``, exact on the CPU only for
    ``|scale_exp| <= 12``).  Subnormal inputs quantize as zero, as they do
    on the reference's platforms (XLA on the CPU and the TPU flush them):
    scaled up by a negative ``scale_exp`` one would otherwise decode below
    the clamp at 2^-126 and break the rewrite invariant.  Pruned values get
    the positive-sign sentinel code, so requantizing their +0.0 reproduces
    the same code."""
    xf = x.float()
    xf = torch.where((xf.view(torch.int32) >> 23) & 0xFF == 0, 0.0, xf)
    neg = -scale_exp.to(torch.int32)
    half = torch.div(neg, 2, rounding_mode="floor")
    scaled = xf * _pow2(half) * _pow2(neg - half)
    q = log2_quantize(scaled, n_bits)
    sign = torch.where(q.exp == zero_sentinel(n_bits), 1, q.sign.to(
        torch.int32)).to(torch.int8)
    return pack_codes(LogQuantized(exp=q.exp, sign=sign), n_bits)


def dequantize_page_codes(codes: torch.Tensor, scale_exp: torch.Tensor,
                          n_bits: int = 4,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``sign * 2^(exp + scale_exp)`` with the sentinel decoding to +0.

    The summed exponent is clamped to ``[-126, 127]``, so garbage scales
    (trash-page contents) decode finite; the power of two is exact (the
    reference's XLA ``exp2`` is off by up to about 4e-6 relative outside
    ``[-12, 12]`` and gives 0 at -126 on the CPU)."""
    q = unpack_codes(codes, n_bits)
    e = torch.clamp(q.exp.to(torch.int32) + scale_exp.to(torch.int32),
                    -126, 127)
    val = q.sign.float() * _pow2(e)
    return torch.where(q.exp == zero_sentinel(n_bits), 0.0, val).to(dtype)


def negative_fraction(q: LogQuantized, n_bits: int = 4) -> torch.Tensor:
    """Share of the live (non-pruned) activations with a negative exponent
    (paper Fig. 2), a float32 scalar."""
    alive = q.exp != zero_sentinel(n_bits)
    neg = alive & (q.exp < 0)
    return neg.sum().float() / torch.clamp(alive.sum(), min=1).float()


def share(mask: torch.Tensor) -> torch.Tensor:
    """Float32 share of True in ``mask`` as XLA evaluates ``jnp.mean``:
    the count times the float32 reciprocal of the size (its simplifier
    turns the division by a constant into that product)."""
    n = torch.tensor(float(mask.numel()), dtype=torch.float32,
                     device=mask.device)
    return mask.sum().float() * (1.0 / n)


def pruned_fraction(q: LogQuantized, n_bits: int = 4) -> torch.Tensor:
    """Share of activations pruned to the zero sentinel (paper §VI-B)."""
    return share(q.exp == zero_sentinel(n_bits))
