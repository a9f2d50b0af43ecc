"""Training CLI (port of ``src/repro/launch/train.py`` without its mesh
options: ``--mesh`` and ``--model-parallel`` need more than one card).

Random weights from ``--seed`` (``init_params`` with a seeded
``torch.Generator``), the deterministic synthetic data keyed by ``(seed,
step)``, AdamW (warmup 5 steps, cosine over ``max(--steps, 10)``), and
checkpoints every ``--checkpoint-every`` steps, written on a background
thread.  ``--resume auto`` restarts from the newest checkpoint in
``--checkpoint-dir`` and, the data being keyed by step, repeats the
uninterrupted run's steps from there bit for bit.  Prints one JSON line
per logged step (``step``, ``loss``, ``grad_norm``, ``sec``,
``straggler``), as the reference's does::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        [--smoke] [--steps 20] [--global-batch 8] [--seq-len 128] \
        [--micro-batches 1] [--lr 3e-4] [--quant] [--checkpoint-dir DIR] \
        [--checkpoint-every 10] [--resume none|auto] [--seed 0] \
        [--log-every 1] [--device cuda|cpu]

The device defaults to the card (it raises without one); ``--device cpu``
trains on the host.  Steps are eager and run with deterministic kernels
(``train.trainer.deterministic``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models.model import init_params
from repro_torch.optim import adamw
from repro_torch.train.trainer import (StragglerWatchdog, TrainConfig,
                                       deterministic, make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--quant", action="store_true",
                    help="QeiHaN-quantized projections")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # cuBLAS is deterministic only with a fixed workspace, set before its
    # first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dcfg = DataConfig(global_batch=args.global_batch, seq_len=args.seq_len,
                      vocab_size=cfg.vocab_size, seed=args.seed)
    data = SyntheticLM(dcfg)
    tcfg = TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr, warmup_steps=5,
                                    total_steps=max(args.steps, 10)),
        micro_batches=args.micro_batches, quant=args.quant)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=dev)
    opt_state = adamw.init(params)

    step0 = 0
    mgr = None
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir, keep=3)
        if args.resume == "auto" and mgr.latest_step() is not None:
            step0 = mgr.latest_step()
            state = mgr.restore(step0, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"[train] resumed from step {step0}")

    step_fn = make_train_step(cfg, tcfg)
    watchdog = StragglerWatchdog()
    with deterministic():
        for step in range(step0, args.steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(step).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow = watchdog.observe(dt)
            if step % args.log_every == 0:
                print(json.dumps({"step": step, "loss": round(loss, 4),
                                  "grad_norm": round(float(
                                      metrics["grad_norm"]), 3),
                                  "sec": round(dt, 3),
                                  "straggler": bool(slow)}), flush=True)
            if mgr and (step + 1) % args.checkpoint_every == 0:
                mgr.save_async(step + 1, {"params": params, "opt": opt_state})
    if mgr:
        mgr.wait()
    print("[train] done")


if __name__ == "__main__":
    main()
