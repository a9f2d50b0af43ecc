"""Memory-access accounting — paper §III (Fig. 3) and §VI-A (Fig. 9).

Port of ``src/repro/core/access_model.py``: the weight bits one activation
exponent makes the D&S unit fetch, and the per-layer traffic report at two
granularities:

* ``element`` — the ASIC's bank-level model: each activation touches
  exactly ``needed(e) * M`` weight bits (paper Fig. 7);
* ``tile`` — a plane is fetched for a whole ``tile_k`` run of activations
  iff any of them needs it (the TPU kernel's skip table, which K2's skip
  rule follows).

Counts are exact int64; the savings fractions are float32 divisions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.logquant import LogQuantized, share, zero_sentinel

__all__ = ["needed_bits", "AccessReport", "weight_access_report"]

WEIGHT_BITS = 8


def needed_bits(exp: torch.Tensor, n_bits: int = 4,
                weight_bits: int = WEIGHT_BITS) -> torch.Tensor:
    """Sentinel -> 0; ``e < 0`` -> ``weight_bits - |e|``; else all bits."""
    e = exp.to(torch.int32)
    nb = torch.clamp(weight_bits + torch.clamp(e, max=0), 0, weight_bits)
    return torch.where(e == zero_sentinel(n_bits), 0, nb)


class AccessReport(NamedTuple):
    """All quantities are per output-feature set of M weights per act."""

    element_bits: torch.Tensor      # bits fetched, ASIC bank granularity
    tile_bits: torch.Tensor         # bits fetched, tile granularity
    baseline_bits: torch.Tensor     # NaHiD: all weight bits per live act
    savings_element: torch.Tensor   # Fig. 3 number (live acts only)
    savings_tile: torch.Tensor
    pruned_fraction: torch.Tensor


def weight_access_report(q: LogQuantized, n_bits: int = 4,
                         weight_bits: int = WEIGHT_BITS,
                         tile_k: int = 256) -> AccessReport:
    """Traffic report for one layer's activation codes ``q`` (flattened).

    The baseline fetches ``weight_bits`` for every live activation (both
    designs prune), so the savings are over live activations only.  The
    tile count pads the codes to a multiple of ``tile_k`` with dead tiles.
    """
    exp = q.exp.reshape(-1)
    live = exp != zero_sentinel(n_bits)
    nb = needed_bits(exp, n_bits, weight_bits).long()
    element_bits = nb.sum()
    baseline_bits = live.long().sum() * weight_bits

    pad = (-exp.numel()) % tile_k
    tiles_nb = torch.nn.functional.pad(nb, (0, pad)).reshape(-1, tile_k)
    live_any = torch.nn.functional.pad(live, (0, pad)).reshape(
        -1, tile_k).any(dim=1)
    planes_per_tile = tiles_nb.amax(dim=1)
    tile_bits = torch.where(live_any, planes_per_tile, 0).sum() * tile_k
    tile_baseline = live_any.long().sum() * (weight_bits * tile_k)

    denom = torch.clamp(baseline_bits, min=1).float()
    tdenom = torch.clamp(tile_baseline, min=1).float()
    return AccessReport(
        element_bits=element_bits,
        tile_bits=tile_bits,
        baseline_bits=baseline_bits,
        savings_element=1.0 - element_bits.float() / denom,
        savings_tile=1.0 - tile_bits.float() / tdenom,
        pruned_fraction=share(~live),
    )
