"""Activation exponent statistics feeding the simulator.

Port of ``src/repro/simulator/stats.py``.  An :class:`ActStats` is a
probability histogram over live (non-pruned) LOG2 exponents ``[-7..7]``
plus the pruned fraction.  Two sources:

* :func:`measure` — from the LOG2 codes of real activations (the paper
  nets' recorded GEMM inputs, ``models/paper_nets.py``), counted on the
  codes' own device; only the 15-bin histogram crosses to the host.
* :func:`paper_preset` — synthetic discretized-Gaussian histograms whose
  negative-exponent fraction and pruned fraction match the numbers printed
  in the paper (Fig. 2 and §VI-B), used to cross-check the simulator against
  the paper's own activation distributions independent of our model weights.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.logquant import LogQuantized, zero_sentinel

EXP_LO, EXP_HI = -7, 7          # live exponent range (-8 is the sentinel)
N_BINS = EXP_HI - EXP_LO + 1


@dataclass(frozen=True)
class ActStats:
    hist: np.ndarray            # (15,) probs over exponents -7..7 (live acts)
    zero_frac: float            # pruned fraction (zeros + clipped-small)

    @property
    def negative_fraction(self) -> float:
        return float(self.hist[: -EXP_LO].sum())

    def mean_needed_bits(self, weight_bits: int = 8) -> float:
        """E[bits fetched per live activation] under the QeiHaN layout."""
        exps = np.arange(EXP_LO, EXP_HI + 1)
        need = np.where(exps < 0, weight_bits + exps, weight_bits)
        return float((self.hist * need).sum())

    def estimated_memory_savings(self, weight_bits: int = 8) -> float:
        """Paper Fig. 3: ignored weight-bit fraction over live activations."""
        return 1.0 - self.mean_needed_bits(weight_bits) / weight_bits


def measure(q: LogQuantized, n_bits: int = 4) -> ActStats:
    """Exponent histogram and pruned share of ``q``'s codes.  The counts
    are exact integers on the codes' device; the host divides them in
    float64 as the reference does."""
    exp = q.exp.reshape(-1)
    live = exp[exp != zero_sentinel(n_bits)].long()
    zero_frac = 1.0 - live.numel() / max(exp.numel(), 1)
    counts = torch.bincount(live - EXP_LO, minlength=N_BINS)
    hist = counts.cpu().numpy().astype(np.float64)
    hist = hist / max(hist.sum(), 1.0)
    return ActStats(hist=hist, zero_frac=float(zero_frac))


def gaussian_stats(center: float, sigma: float, zero_frac: float) -> ActStats:
    exps = np.arange(EXP_LO, EXP_HI + 1, dtype=np.float64)
    h = np.exp(-0.5 * ((exps - center) / sigma) ** 2)
    h /= h.sum()
    return ActStats(hist=h, zero_frac=zero_frac)


def _calibrate_center(target_neg: float, sigma: float,
                      zero_frac: float) -> ActStats:
    """Binary-search the Gaussian center to hit a negative-exponent target."""
    lo, hi = -8.0, 8.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        s = gaussian_stats(mid, sigma, zero_frac)
        if s.negative_fraction > target_neg:
            lo = mid
        else:
            hi = mid
    return gaussian_stats(0.5 * (lo + hi), sigma, zero_frac)


# (negative-exponent fraction [Fig. 2], pruned fraction [§VI-B], sigma)
_PAPER_NUMBERS = {
    "alexnet": (0.36, 0.47, 2.6),      # "most symmetric distribution"
    "transformer": (0.57, 0.03, 2.6),
    "ptblm": (0.98, 0.55, 1.6),        # concentrated around -3
    "bert-base": (0.82, 0.07, 1.9),
    "bert-large": (0.85, 0.13, 1.9),
}


def paper_preset(model: str) -> ActStats:
    neg, zero, sigma = _PAPER_NUMBERS[model]
    return _calibrate_center(neg, sigma, zero)
