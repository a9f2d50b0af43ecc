"""Serving CLI, one-shot mode (port of the one-shot path of
``src/repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        [--smoke] [--batch 4] [--prompt-len 32] [--new-tokens 16] \
        [--quant] [--pack] [--eos-id N] [--seed 0] [--device cuda|cpu]

Random weights from ``--seed``, a random prompt batch, prefill, then the
decode loop; prints the prefill time, decode tok/s, the tile- and
element-granular plane-traffic fractions (``--quant``) and sample tokens.
The device defaults to the card; ``--device cpu`` runs the plain-PyTorch
path on the host.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.models.model import init_caches, init_params
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving.engine import make_decode_loop, make_prefill_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--quant", action="store_true")
    ap.add_argument("--pack", action="store_true",
                    help="serve packed bit-planes (int8-footprint deploy "
                         "format)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop early once every row emitted this token id")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=dev)
    if args.quant:
        params = quantize_model_params(cfg, params, pack=args.pack)
    caches = init_caches(cfg, args.batch, args.prompt_len + args.new_tokens,
                         dtype=cfg.dtype, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)

    prefill = make_prefill_step(cfg, args.quant)
    decode = make_decode_loop(cfg, args.new_tokens, quant=args.quant,
                              eos_id=args.eos_id, with_stats=args.quant)
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompt}, caches)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t1 = time.perf_counter()
    toks, stats = decode(params, caches, logits, gen)
    _sync(dev)
    t_decode = time.perf_counter() - t1

    toks_h = toks.cpu().numpy()
    if args.eos_id is None:
        total_new = toks_h.size
        steps = args.new_tokens
    else:
        # per-row tokens up to and including the first EOS; only the steps
        # that ran (later slots are EOS padding with zero stats)
        hits = toks_h == args.eos_id
        first = (hits.argmax(1) + 1) * hits.any(1) + \
            args.new_tokens * ~hits.any(1)
        total_new = int(first.sum())
        steps = int(first.max()) if args.new_tokens else 0
    print(f"[serve] {cfg.name} on {dev}: prefill {args.batch}x"
          f"{args.prompt_len} in {t_prefill:.3f}s; {total_new} tokens "
          f"decoded in {t_decode:.3f}s "
          f"({total_new / max(t_decode, 1e-9):.1f} tok/s, eager)")
    if stats is not None and steps:
        tile_all = stats["plane_traffic_fraction"][:steps].cpu()
        elem_all = stats["element_traffic_fraction"][:steps].cpu()
        ran = tile_all > 0
        tile = float(tile_all[ran].mean()) if ran.any() else 0.0
        elem = float(elem_all[ran].mean()) if ran.any() else 0.0
        print(f"[serve] plane_traffic_fraction: {tile:.3f} tile-granular "
              f"(kernel reads), {elem:.3f} element-granular (ASIC model)")
    print("sample tokens:", toks_h[0, :8].tolist())


if __name__ == "__main__":
    main()
