"""Plain-PyTorch oracle for the LOG2 quantizer, independent of
``core.logquant``: ``torch.frexp`` gives the exact mantissa/exponent split,
so oracle and kernel share no bit extraction (port of
``src/repro/kernels/log2quant/ref.py``)."""

from __future__ import annotations

import math

import torch


def log2_quantize_ref(x: torch.Tensor, n_bits: int = 4):
    sentinel = -(1 << (n_bits - 1))
    emax = (1 << (n_bits - 1)) - 1
    xf = x.float()
    mant, expo = torch.frexp(xf.abs())        # |x| = mant * 2^expo, [0.5, 1)
    # float32(sqrt(2)/2) rounds below the true value and no float32 mantissa
    # lies between them, so "m >= sqrt(2)" is the strict compare here.
    half_sqrt2 = torch.tensor(math.sqrt(2.0) / 2.0, dtype=torch.float32)
    rounded = (expo - 1) + (mant > half_sqrt2).to(torch.int32)
    e = torch.clamp(rounded, sentinel, emax)
    e = torch.where((xf == 0) | torch.isnan(xf), sentinel, e)
    e = torch.where(torch.isinf(xf), emax, e)
    sign = torch.where(xf < 0, -1, 1).to(torch.int8)
    return e.to(torch.int8), sign
