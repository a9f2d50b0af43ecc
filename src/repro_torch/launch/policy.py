"""Layout policy: which mesh axes carry DP/FSDP/TP/EP per (arch x step)
(a copy of ``src/repro/launch/policy.py``; serving uses the ``tp``
layout, the only one this package runs so far).

Derived from first-principles traffic math; EXPERIMENTS.md §Perf records the
measurements behind each choice:

* **Dense training (fsdp)** — batch shards over *all* axes; params shard
  FSDP over all axes.  Per-chip collective traffic ~3x params (gather
  fwd/remat/bwd) + grad reduce-scatter — measured 6x less than Megatron
  TP=16+SP at 32B/256 chips (activation gathers dwarf weights).
* **MoE training (ep)** — same FSDP layout for attention/dense/embeddings,
  plus **EP**: expert weights live un-gathered on the ``model`` axis and the
  token buffers move through two tiled all_to_alls inside the MoE shard_map
  (models/moe.py).  Attention TP hints stay OFF — mixing head-TP with EP
  measured 1.5 TiB/chip of flash-backward all-gathers.
* **Serving (tp)** — TP on model for every arch: weights must be resident
  (per-token FSDP gathers would melt the ICI), batch on pod x data, KV cache
  sequence-sharded on model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.models.model import ModelConfig


@dataclass(frozen=True)
class LayoutPolicy:
    batch_axes: Tuple[str, ...]
    model_axis: Optional[str]          # TP hint axis (None = no TP hints)
    ep_axis: Optional[str]             # expert-parallel shard_map axis
    fsdp_axes: Tuple[str, ...]         # param-sharding axes
    seq_shard: bool                    # SP for scan-carried residuals
    fsdp: bool = True
    tp_scope: str = "all"              # 'all' | 'experts': which param rules
                                       # bind the model axis

    def describe(self) -> str:
        return (f"batch={self.batch_axes} tp={self.model_axis} "
                f"ep={self.ep_axis} "
                f"fsdp={self.fsdp_axes if self.fsdp else None} "
                f"sp={self.seq_shard} scope={self.tp_scope}")


def for_cell(cfg: ModelConfig, step: str, mesh,
             override: Optional[str] = None,
             global_batch: Optional[int] = None) -> LayoutPolicy:
    """Baseline policy per (arch, step); ``override`` forces a named layout
    (used by the §Perf hillclimb: 'tp', 'fsdp', 'ep', 'ep_dp').

    Divisibility fallback: pure-FSDP needs the batch to shard over the whole
    mesh; when it cannot (e.g. batch 256 on the 512-chip 2-pod mesh), an
    idle model axis makes GSPMD bounce activations (measured 22 TiB/chip on
    qwen3 train) — fall back to DP x TP (dense) / DP x EP + SP (MoE)."""
    axes = tuple(mesh.axis_names)
    pods = tuple(a for a in axes if a == "pod")
    name = override or ("ep" if cfg.n_experts and step == "train" else
                        "fsdp" if step == "train" else "tp")
    covers = (global_batch is None or global_batch % mesh.size == 0)
    if name == "fsdp" and not covers:
        name = "tp"
    if name == "ep" and not covers:
        name = "ep_dp"

    if name == "fsdp":                     # dense training default
        return LayoutPolicy(batch_axes=axes, model_axis=None, ep_axis=None,
                            fsdp_axes=axes, seq_shard=False)
    if name == "ep":                       # MoE training default
        return LayoutPolicy(batch_axes=axes, model_axis=None,
                            ep_axis="model", fsdp_axes=axes,
                            seq_shard=False, tp_scope="experts")
    if name == "ep_dp":                    # MoE train, batch < mesh: DP over
        return LayoutPolicy(                # pod x data, EP + seq-split MoE
            batch_axes=pods + ("data",), model_axis=None, ep_axis="model",
            fsdp_axes=pods + ("data",), seq_shard=True, tp_scope="experts")
    if name == "tp":                       # serving default / megatron train
        return LayoutPolicy(batch_axes=pods + ("data",), model_axis="model",
                            ep_axis="model",
                            fsdp_axes=pods + ("data",) if step == "train" else (),
                            seq_shard=step != "serve", fsdp=step == "train")
    raise ValueError(f"unknown layout {name!r}")
