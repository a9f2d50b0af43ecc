"""LOG2 activation quantization — QeiHaN paper Eqs. 2-4 (Fig. 5 comparator).

Port of ``src/repro/core/logquant.py`` (the quantizer and its inverse).
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
           "log2_dequantize"]

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


def log2_dequantize(q: LogQuantized, n_bits: int = 4,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``sign * 2^exp`` with the sentinel decoding to exactly 0."""
    mag = torch.exp2(q.exp.float())
    val = q.sign.float() * mag
    return torch.where(q.exp == zero_sentinel(n_bits), 0.0, val).to(dtype)
