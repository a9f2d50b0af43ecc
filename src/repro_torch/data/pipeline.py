"""Deterministic synthetic LM data pipeline (a copy of
``src/repro/data/pipeline.py``, numpy only: the reference's package
``repro.data`` cannot be imported without JAX).  Batches are bit-equal to
the reference's for any ``(seed, step, shard, n_shards)``.

Counter-based (Philox) generation keyed by ``(seed, step, shard)`` — any
worker can materialize any batch independently, which is what makes
checkpoint/restart and *elastic* restarts replay identical data without a
data-service dependency.  Token stream is Zipf-distributed (vocab-realistic
marginals) with a short-range Markov flavor so losses move during smoke
training runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """``batch(step, shard, n_shards)`` -> host numpy batch for that shard."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % 1:
            raise ValueError
        # stationary Zipf marginal over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._probs = p / p.sum()

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"batch {cfg.global_batch} % shards {n_shards}")
        local = cfg.global_batch // n_shards
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed, counter=[step, shard, 0, 0]))
        toks = rng.choice(cfg.vocab_size, size=(local, cfg.seq_len + 1),
                          p=self._probs).astype(np.int32)
        # short-range structure: every other position repeats its neighbor
        # with p=0.25 so next-token prediction is learnable
        rep = rng.random((local, cfg.seq_len)) < 0.25
        toks[:, 1:][rep] = toks[:, :-1][rep]
        return {"tokens": toks[:, :-1],
                "labels": toks[:, 1:].astype(np.int32)}
