"""Memory-access accounting — paper §III (Fig. 3) and §VI-A (Fig. 9).

Port of ``needed_bits`` from ``src/repro/core/access_model.py``: the
element-granular (ASIC bank-level) count of weight bits one activation
exponent makes the D&S unit fetch.
"""

from __future__ import annotations

import torch

from repro_torch.core.logquant import zero_sentinel

__all__ = ["needed_bits"]

WEIGHT_BITS = 8


def needed_bits(exp: torch.Tensor, n_bits: int = 4,
                weight_bits: int = WEIGHT_BITS) -> torch.Tensor:
    """Sentinel -> 0; ``e < 0`` -> ``weight_bits - |e|``; else all bits."""
    e = exp.to(torch.int32)
    nb = torch.clamp(weight_bits + torch.clamp(e, max=0), 0, weight_bits)
    return torch.where(e == zero_sentinel(n_bits), 0, nb)
