"""AdamW with global-norm clipping and a warmup-cosine schedule over the
port's trees of tensors (port of the reference's ``optim/adamw.py``).

Moments are f32 whatever the param dtype; the step counter is an int32
scalar tensor on the params' device; each leaf is updated as
``(p.float() - lr * delta).to(p.dtype)``.  ``global_norm`` sums the leaves
in ``jax.tree.leaves`` order (``repro_torch.tree``), so ``grad_norm`` groups
its f32 sum as the reference's does.  The update is functional: it returns
new trees and leaves its inputs as they were.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine to
    ``min_lr_ratio * lr`` at ``total_steps``; f32, for an int or a
    tensor ``step``."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> Dict[str, Any]:
    """Zero f32 moments ``m`` and ``v`` shaped like ``params`` and the
    int32 step 0, on the params' device."""
    first = leaves(params)[0]
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves(tree)))


def update(cfg: AdamWConfig, grads, state, params
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``(new_params, new_state, {"grad_norm", "lr"})``.
    ``grads`` has ``params``' structure, in any float dtype."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.tensor(cfg.clip_norm, dtype=torch.float32,
                        device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / bc1
        vh = v / bc2
        delta = (mh / (torch.sqrt(vh) + cfg.eps)
                 + cfg.weight_decay * p.float())
        return (p.float() - lr * delta).to(p.dtype), m, v

    paths = [path for path, _ in flatten_with_path(params)]
    flat = []
    for tree in (params, grads, state["m"], state["v"]):
        got = flatten_with_path(tree)
        if [path for path, _ in got] != paths:
            raise ValueError("grads or moments differ from params in "
                             "structure")
        flat.append([leaf for _, leaf in got])
    out = [upd(*xs) for xs in zip(*flat)]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
