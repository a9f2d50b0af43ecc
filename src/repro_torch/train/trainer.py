"""Train steps over the port's trees of tensors (port of
``src/repro/train/trainer.py``): the loss, micro-batch gradient
accumulation in f32, AdamW, the straggler watchdog and the host loop.

The step is eager PyTorch, the counterpart of the reference's ``jit``:
gradients come from ``torch.autograd.grad`` over every leaf of the params
tree (a float tree: the reference's training trees carry no quantized
``*_q`` leaves, so ``quant=True`` takes the float projections as there).
:func:`train_loop` runs under :func:`deterministic`, so that a resumed run
repeats an uninterrupted one bit for bit on the card.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.model import ModelConfig, next_token_loss
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)
    micro_batches: int = 1              # gradient accumulation factor
    quant: bool = False                 # QeiHaN-quantized projections


def make_loss_fn(cfg: ModelConfig, quant: bool = False) -> Callable:
    def loss_fn(params, batch):
        return next_token_loss(cfg, params, batch, quant=quant)
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)``: the loss detached and the gradient of every
    leaf, in the leaf's dtype, as ``params``' tree."""
    flat = leaves(params)
    bad = [tuple(p.shape) for p in flat if not p.is_floating_point()]
    if bad:
        raise TypeError(f"non-float leaves {bad}: train a float tree")
    with torch.enable_grad():
        tracked = [p.detach().requires_grad_() for p in flat]
        loss = loss_fn(unflatten(params, tracked), batch)
        grads = torch.autograd.grad(loss, tracked, allow_unused=True)
    # a leaf the loss does not read (the audio stub's embedding table)
    # gets a zero gradient, as under jax.grad
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``.

    With ``micro_batches = n > 1`` each batch leaf's leading dim ``b`` is
    split as ``reshape(n, b // n, ...)``; the micro-batches run one after
    another, their gradients summed in f32 in order from zero and divided
    by ``n``, and so is the loss.
    """
    loss_fn = make_loss_fn(cfg, tcfg.quant)

    def train_step(params, opt_state, batch):
        n = tcfg.micro_batches
        if n <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            micro = {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])
                     for k, x in batch.items()}
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(n):
                mb_loss, g = value_and_grad(
                    loss_fn, params, {k: x[i] for k, x in micro.items()})
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + mb_loss
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        params, opt_state, metrics = adamw.update(
            tcfg.optimizer, grads, opt_state, params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels while the block runs, the earlier setting
    after: on the card the embedding gather's backward (an accumulating
    scatter) otherwise adds in the order its atomics land.  An op without
    a deterministic version warns instead of raising.  cuBLAS needs
    ``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8``) set before the first CUDA
    call to be deterministic too."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


class StragglerWatchdog:
    """Tracks per-step wall time; flags steps slower than ``factor`` x the
    running median.  At cluster scale the flag feeds the orchestration layer
    (preempt/replace the slow host); here it logs and counts."""

    def __init__(self, factor: float = 3.0, warmup: int = 3):
        self.factor = factor
        self.warmup = warmup
        self.times = []
        self.flagged = 0

    def observe(self, seconds: float) -> bool:
        self.times.append(seconds)
        if len(self.times) <= self.warmup:
            return False
        hist = sorted(self.times[:-1])
        median = hist[len(hist) // 2]
        slow = seconds > self.factor * median
        self.flagged += int(slow)
        return slow


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, params, opt_state,
               batches, *, step0: int = 0,
               hook: Optional[Callable[[int, Dict[str, Any]], None]] = None):
    """Generic host loop (single process; ``launch/train.py`` adds
    checkpointing): one step per batch from ``step0``, each timed on the
    host clock up to its loss on the device; ``hook(step, metrics)`` gets
    ``step_time_s`` and ``straggler`` beside the step's metrics."""
    step_fn = make_train_step(cfg, tcfg)
    watchdog = StragglerWatchdog()
    metrics = {}
    with deterministic():
        for step, batch in enumerate(batches, start=step0):
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if metrics["loss"].is_cuda:
                torch.cuda.synchronize(metrics["loss"].device)
            dt = time.perf_counter() - t0
            slow = watchdog.observe(dt)
            if hook:
                hook(step, {**metrics, "step_time_s": dt, "straggler": slow})
    return params, opt_state, metrics
