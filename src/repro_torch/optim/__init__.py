"""Optimizers (mirrors the reference's ``optim`` package; ``compress.py``,
which works across devices, is not ported yet)."""

from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["adamw", "AdamWConfig"]
