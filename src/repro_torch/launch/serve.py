"""Serving CLI (port of ``src/repro/launch/serve.py``).

One-shot mode: random weights from ``--seed``, a random prompt batch,
prefill, then the decode loop; prints the prefill time, decode tok/s, the
tile- and element-granular plane-traffic fractions (``--quant``) and
sample tokens::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        [--smoke] [--batch 4] [--prompt-len 32] [--new-tokens 16] \
        [--quant] [--pack] [--eos-id N] [--seed 0] [--device cuda|cpu]

``--continuous`` serves a queued trace of variable-length prompts through
the continuous-batching scheduler (``serving/scheduler.py``); the flags
map to a ``ServeConfig`` exactly as the reference's do, so
``--dump-config`` writes the same JSON and ``--config`` reads either
package's::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --continuous --requests 16 --max-slots 4 --new-tokens 16 \
        [--chunked [auto|always]] [--chunk-len N] [--paged] [--page-len N] \
        [--prefix-cache] [--attn-kernel] [--attn-splits N] [--quant] \
        [--kv-quant [BITS]] [--config serve.json] [--dump-config [PATH]] \
        [--disaggregate]

``--disaggregate`` serves the same trace through the prefill/decode
router (``serving/router.py``) instead of the combined scheduler: the
same tokens, the decode fleet's ticks timed apart from prompt ingestion.
It needs a paged config.

``--arch`` takes every configuration of ``repro_torch.configs`` (the
reference's ten); ``--kv-quant`` on a model without an attention layer
(``attn`` or ``attn_moe``) is refused, as its pool holds recurrent state
only.  A vision-stub model (internvl2-26b) serves one-shot from a random
prompt and random patch embeddings: the prefill step and the decode loop
each as one program, over a cache of ``n_image_tokens + prompt_len +
new_tokens`` rows, the patches' rows included.  The audio stub
(musicgen-medium) is refused, as in the reference, and so is the
scheduler for either stub.  There is no flag for ``drop_float``, as in
the reference: the float weights and the planes of a quantized model are
both resident (qwen3-32b's do not fit one card together).

The device defaults to the card, where every serving step runs as a
CUDA-graph replay (its first call captures it: the one-shot mode times a
second, replayed generate after the capture); ``--device cpu`` runs the
same program bodies eagerly with the kernels' plain versions on the host.
Continuous mode prints the scheduler's ``compile_stats()``.

``--mesh DxM`` (or ``host`` with ``--model-parallel M``) serves either mode
as ``M`` ranks on the model axis (``launch/shardings.py``: heads, MLP
columns, vocab and experts cut over the ranks, the bit-planes with their
weights), with the single card's tokens; a data axis (``D > 1``) is
refused.  The ranks are ``--host-devices N`` threads on ``--device`` (the
reference's flag; on the card they run eagerly, as a graph cannot hold
their hand-overs on the host), or, with ``--nccl``, one process per visible card
over NCCL, whose programs are CUDA graphs.  Only rank 0 prints::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \
        --continuous --paged --mesh 1x4 --host-devices 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \
        --quant --pack --mesh 1x4 --nccl

``--disaggregate`` with a mesh is refused: the router is not sharded.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import socket
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch.mesh import DATA_AXIS_REASON, make_serve_mesh
from repro_torch.launch.shardings import cut_shards, params_shardings
from repro_torch.models import sharding
from repro_torch.models.model import base_kind, init_caches, init_params
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import engine
from repro_torch.serving.engine import (Program, greedy_generate,
                                        make_decode_loop, make_prefill_step)


def _print(*args, **kw) -> None:
    """``print`` on rank 0 only (every process outside a mesh)."""
    if sharding.model_rank() == 0:
        print(*args, **kw)


def _mesh_tag(mesh) -> str:
    return ("1-device" if mesh is None else
            f"{mesh.shape['data']}x{mesh.shape['model']} mesh, "
            f"{mesh.kind} group")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _path(dev: torch.device) -> str:
    return ("CUDA-graph replay, captures included" if dev.type == "cuda"
            else "eager, host")


def build_serve_config(args):
    """Flags -> :class:`~repro_torch.serving.config.ServeConfig` for
    ``--continuous``, the reference's mapping: buckets from
    ``--prompt-len``, a pool long enough for the longest trace prompt plus
    generation and one tick, rounded once to the lcm of the chunk and
    page lengths."""
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.scheduler import round_pool_len

    buckets = tuple(sorted({8, 16, max(8, args.prompt_len)}))
    chunked = args.chunked or "off"
    chunk_len = args.chunk_len or 8
    long_max = (3 * args.prompt_len) if chunked != "off" else args.prompt_len
    pool = max(long_max, max(buckets)) + args.new_tokens + args.tick_steps
    quantum = 1
    if chunked != "off" or args.prefix_cache:
        quantum = chunk_len
    kv_quant = args.kv_quant is not None
    paged = bool(args.paged or args.prefix_cache or args.attn_kernel
                 or kv_quant)
    if paged:
        quantum = math.lcm(quantum, args.page_len)
    if quantum > 1:
        pool = round_pool_len(pool, quantum)
    return ServeConfig(
        max_slots=args.max_slots, max_len=pool, buckets=buckets,
        quant="pallas" if args.quant else False, with_stats=args.quant,
        tick_steps=args.tick_steps, chunked=chunked, chunk_len=chunk_len,
        paged=paged, page_len=args.page_len, prefix_cache=args.prefix_cache,
        attn_kernel="pallas" if args.attn_kernel else "off",
        attn_splits=args.attn_splits, kv_quant=kv_quant,
        kv_bits=args.kv_quant or 4)


def _load_serve_config(args):
    """``--config path.json`` if given, else the flags' config."""
    from repro_torch.serving.config import ServeConfig

    if args.config is None:
        return build_serve_config(args)
    with open(args.config) as fh:
        return ServeConfig.from_json(fh.read())


def _serve_continuous(cfg, params, args, dev, mesh=None):
    """Submit a seeded trace, drain it, report tok/s, latency, plane
    traffic and prefix-cache hits.  With chunking the trace draws prompts
    up to 3x ``--prompt-len``; with the prefix cache 3 in 4 prompts start
    with a shared half-length prefix.  ``--disaggregate`` serves it
    through the prefill/decode router."""
    from repro_torch.serving.router import Router
    from repro_torch.serving.scheduler import ServeScheduler

    config = _load_serve_config(args)
    chunked = config.chunked
    long_max = ((3 * args.prompt_len) if chunked != "off"
                else args.prompt_len)
    if args.disaggregate:
        if not config.paged:
            raise SystemExit("--disaggregate requires a paged config "
                             "(add --paged, or paged=true in --config)")
        sched = Router(cfg, params, config, device=dev)
    else:
        sched = ServeScheduler(cfg, params, config, device=dev, mesh=mesh)
    rng = np.random.default_rng(args.seed)
    prefix = (rng.integers(0, cfg.vocab_size, size=max(args.prompt_len // 2,
                                                       config.page_len))
              .astype(np.int32) if config.prefix_cache else None)
    for _ in range(args.requests):
        n = int(rng.integers(2, long_max + 1))
        p = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        if prefix is not None and rng.random() < 0.75:
            p = np.concatenate([prefix, p])[:max(long_max, len(prefix) + 2)]
        sched.submit(p, max_new=args.new_tokens, eos_id=args.eos_id)
    _sync(dev)
    t0 = time.perf_counter()
    results = sched.run()
    _sync(dev)
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in results)
    tag = "" if chunked == "off" else f", chunked={chunked}/{config.chunk_len}"
    if config.paged:
        tag += (f", paged/{config.page_len}"
                + ("+prefix" if config.prefix_cache else "")
                + (f"+kernel/s{config.attn_splits}"
                   if config.attn_kernel != "off" else "")
                + (f"+kvq/{config.kv_bits}b" if config.kv_quant else ""))
    if args.disaggregate:
        mode = "disaggregated"
        compile_stats = {"prefill": sched.prefill.scheduler.compile_stats(),
                         "decode": sched.decode.scheduler.compile_stats()}
        stats_sched = sched.prefill.scheduler
    else:
        mode = "continuous batching"
        compile_stats = sched.compile_stats()
        stats_sched = sched
    if mesh is not None:
        mode = f"{mode} ({_mesh_tag(mesh)}{tag})"
        tag = ""
    _print(f"[serve] {cfg.name} on {dev}: {mode}{tag} — "
          f"{len(results)} requests, {config.max_slots} slots, "
          f"tick={config.tick_steps}: {total} tokens in {dt:.3f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s, {_path(dev)})")
    _print(f"[serve] compile_stats: {compile_stats}")
    if args.disaggregate and sched.decode_tick_times:
        tt = np.asarray(sched.decode_tick_times) * 1e3
        _print(f"[serve] decode fleet: {len(tt)} isolated ticks, p50/p95 "
              f"{np.percentile(tt, 50):.1f}/{np.percentile(tt, 95):.1f} ms "
              f"(prefill work excluded by construction)")
    served = [r for r in results if r.finish_reason != "rejected"]
    if served:
        ttft = [r.first_token_time - r.submit_time for r in served]
        e2e = [r.finish_time - r.submit_time for r in served]
        _print(f"[serve] latency: ttft p50/p95 "
              f"{np.percentile(ttft, 50) * 1e3:.1f}/"
              f"{np.percentile(ttft, 95) * 1e3:.1f} ms, e2e p50/p95 "
              f"{np.percentile(e2e, 50) * 1e3:.1f}/"
              f"{np.percentile(e2e, 95) * 1e3:.1f} ms; {len(served)}/"
              f"{len(results)} served, longest prompt "
              f"{max(r.prompt_len for r in served)} tokens "
              f"(buckets cap {max(config.buckets)})")
    if args.quant and served:
        tile = float(np.mean([r.plane_traffic_fraction for r in served]))
        elem = float(np.mean([r.element_traffic_fraction for r in served]))
        _print(f"[serve] per-request plane_traffic_fraction: {tile:.3f} "
              f"tile-granular, {elem:.3f} element-granular")
    if config.prefix_cache:
        st = stats_sched.prefix_cache_stats()
        _print(f"[serve] prefix cache: hit_rate {st['hit_rate']:.3f} "
              f"({int(st['cached_tokens'])}/{int(st['prompt_tokens'])} "
              f"prompt tokens from shared pages, "
              f"{int(st['lookup_hits'])}/{int(st['lookups'])} lookups hit; "
              f"pages {int(st['pages_in_use'])} in use / "
              f"{int(st['pages_free'])} free)")
    if results:
        r0 = results[0]
        _print(f"sample request 0 ({r0.finish_reason}):", r0.tokens[:8])
    return results


def _vision_generate(cfg, params, prompt, img, args, dev):
    """The vision stub's one-shot serving: ``make_prefill_step`` over
    ``{"tokens", "image_embeds"}`` and ``make_decode_loop`` over its
    cache, each one :class:`Program`.  The cache holds the patches' rows
    too (``n_image_tokens + prompt_len + new_tokens``): the reference's
    CLI sizes it without them.  Returns a function that runs both and
    gives ``(tokens, stats or None)``."""
    b, n = prompt.shape
    caches = init_caches(cfg, b, cfg.n_image_tokens + n + args.new_tokens,
                         dtype=cfg.dtype, device=dev)
    prefill = make_prefill_step(cfg, args.quant)
    decode = make_decode_loop(cfg, args.new_tokens, quant=args.quant,
                              eos_id=args.eos_id, with_stats=args.quant)
    filled = {}

    def prefill_body(tokens, image_embeds):
        logits, filled["caches"] = prefill(
            params, {"tokens": tokens, "image_embeds": image_embeds}, caches)
        return (logits,)

    def decode_body(logits):
        toks, stats = decode(params, filled["caches"], logits)
        if stats is None:
            return (toks,)
        return toks, torch.stack([stats["plane_traffic_fraction"],
                                  stats["element_traffic_fraction"]])

    bound = lambda: (params, caches)        # noqa: E731
    progs = (Program(prefill_body, name="prefill", device=dev, bound=bound),
             Program(decode_body, name="decode", device=dev, bound=bound))

    def generate():
        (logits,) = progs[0](prompt, img)
        out = progs[1](logits)
        if not args.quant:
            return out[0].clone(), None
        return out[0].clone(), {"plane_traffic_fraction": out[1][0].clone(),
                                "element_traffic_fraction": out[1][1].clone()}
    return generate


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
    # continuous-batching mode
    ap.add_argument("--continuous", action="store_true",
                    help="serve a queued request trace through the slot "
                         "scheduler instead of one rectangular batch")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--tick-steps", type=int, default=8)
    ap.add_argument("--chunked", nargs="?", const="auto", default=None,
                    choices=["off", "auto", "always"],
                    help="chunked prefill; bare --chunked means 'auto' "
                         "(only over-bucket prompts chunk)")
    ap.add_argument("--chunk-len", type=int, default=None,
                    help="tokens ingested per chunk per tick (default 8)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool: slots share fixed-size pages "
                         "through per-slot page tables")
    ap.add_argument("--page-len", type=int, default=16,
                    help="tokens per KV page (paged mode)")
    ap.add_argument("--attn-kernel", action="store_true",
                    help="paged-attention decode kernel (implies --paged): "
                         "walks the page tables instead of gathering them")
    ap.add_argument("--attn-splits", type=int, default=1,
                    help="split-KV partials of the paged-attention kernel")
    ap.add_argument("--kv-quant", nargs="?", const=4, type=int,
                    default=None, metavar="BITS",
                    help="log2-quantize the KV pages at BITS exponent bits "
                         "(default 4; implies --paged); each slot's newest "
                         "pages stay dense in its tail ring")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over the paged pool (implies "
                         "--paged); the trace draws shared-prefix prompts")
    ap.add_argument("--config", default=None, metavar="PATH",
                    help="load the continuous-mode ServeConfig from this "
                         "JSON file instead of deriving it from the flags")
    ap.add_argument("--dump-config", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="print (or write to PATH) the ServeConfig JSON the "
                         "flags derive, then exit")
    ap.add_argument("--disaggregate", action="store_true",
                    help="continuous mode through the prefill/decode router "
                         "instead of the combined scheduler: the same "
                         "tokens, decode ticks apart from prompt ingestion "
                         "(needs a paged config)")
    ap.add_argument("--mesh", default=None,
                    help="serve on a mesh: 'host' (every rank, "
                         "--model-parallel of them on the model axis) or "
                         "'DxM'; the port shards the model axis only "
                         "(D must be 1).  Default: one device, no group")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--host-devices", type=int, default=None, metavar="N",
                    help="N ranks as threads of this process on --device "
                         "(the local group)")
    ap.add_argument("--nccl", action="store_true",
                    help="one process per rank of --mesh, each on its own "
                         "card, ranks of one NCCL group, each serving its "
                         "shard as CUDA graphs")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.kv_quant is not None and not any(base_kind(k) == "attn"
                                             for k in cfg.pattern):
        ap.error(f"--kv-quant: {cfg.name} has no attention layer; its pool "
                 f"holds SSM/conv state only, which has no KV pages to "
                 f"quantize")

    if args.dump_config is not None:
        text = _load_serve_config(args).to_json(indent=2)
        if args.dump_config == "-":
            print(text)
        else:
            with open(args.dump_config, "w") as fh:
                fh.write(text + "\n")
        return None

    if cfg.frontend == "audio_stub":
        raise SystemExit("use examples/serve_decode.py for the audio stub")
    if args.nccl:
        return _spawn_nccl(args, argv if argv is not None else sys.argv[1:])
    if args.mesh is not None and args.disaggregate:
        raise SystemExit("--disaggregate with --mesh: the prefill/decode "
                         "router is not sharded")
    dev = resolve_device(args.device)
    mesh = None
    if args.mesh is not None:
        group = (None if args.host_devices is None
                 else sharding.LocalGroup(args.host_devices))
        mesh = make_serve_mesh(args.mesh, args.model_parallel, group=group,
                               device=dev)
        if mesh.size == 1:
            mesh = None
    return _serve_mesh(cfg, args, dev, mesh)


def _serve_mesh(cfg, args, dev, mesh):
    """Build the seeded model and prompt, cut each rank's shard and free
    the full tree, then serve on every rank this process runs."""
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=dev)
    if args.quant:
        params = quantize_model_params(cfg, params, pack=args.pack)
    draw = {}
    if not args.continuous:
        draw["prompt"] = torch.randint(
            0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
            device=dev, dtype=torch.int32)
        if cfg.frontend == "vision_stub":
            draw["img"] = torch.randn(
                (args.batch, cfg.n_image_tokens, cfg.d_model), generator=gen,
                device=dev).to(torch.bfloat16)
    if mesh is None:
        return _serve(cfg, params, args, dev, None, **draw)
    if mesh.shape["data"] > 1:
        raise NotImplementedError(f"--mesh {args.mesh}: {DATA_AXIS_REASON}")
    specs = params_shardings(mesh, params, fsdp=False,
                             kv_heads=cfg.n_kv_heads)
    ranks = range(mesh.size) if mesh.kind == "local" else [mesh.group.rank]
    # leaf by leaf, the full tree freed as its shards appear
    shards = dict(zip(ranks, cut_shards(params, specs, mesh, ranks,
                                        consume=True)))
    del params, specs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the ranks of a local group take turns on the host: no CUDA graphs
    scope = (engine.eager() if mesh.kind == "local" and dev.type == "cuda"
             else contextlib.nullcontext())
    with scope:
        out = mesh.run(lambda r: _serve(cfg, shards.pop(r), args, dev, mesh,
                                        **draw))
    return out[0]


def _serve(cfg, params, args, dev, mesh, prompt=None, img=None):
    """One-shot or continuous serving of one rank (or of the one card)."""
    if args.continuous:
        return _serve_continuous(cfg, params, args, dev, mesh)
    if cfg.frontend == "vision_stub":
        generate = _vision_generate(cfg, params, prompt, img, args, dev)
    else:
        def generate():
            out = greedy_generate(cfg, params, prompt, args.new_tokens,
                                  quant=args.quant, eos_id=args.eos_id,
                                  with_stats=args.quant, device=dev,
                                  mesh=mesh)
            return out if args.quant else (out, None)

    _sync(dev)
    t0 = time.perf_counter()
    generate()                       # the first call captures the program
    _sync(dev)
    t_first = time.perf_counter() - t0
    t1 = time.perf_counter()
    toks, stats = generate()
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
    shape = (f" + {cfg.n_image_tokens} image rows, then decode, as two "
             f"programs" if cfg.frontend == "vision_stub"
             else " + decode as one program")
    if mesh is not None:
        shape += f" ({_mesh_tag(mesh)})"
    path = ("eager, ranks as threads" if mesh is not None
            and mesh.kind == "local" and dev.type == "cuda" else _path(dev))
    _print(f"[serve] {cfg.name} on {dev}: prefill {args.batch}x"
           f"{args.prompt_len}{shape}, first call "
           f"{t_first:.3f}s; {total_new} tokens in {t_decode:.3f}s "
           f"({total_new / max(t_decode, 1e-9):.1f} tok/s, {path}, "
           f"prefill included)")
    if args.quant and steps:
        tile_all = stats["plane_traffic_fraction"][:steps].cpu()
        elem_all = stats["element_traffic_fraction"][:steps].cpu()
        ran = tile_all > 0
        tile = float(tile_all[ran].mean()) if ran.any() else 0.0
        elem = float(elem_all[ran].mean()) if ran.any() else 0.0
        _print(f"[serve] plane_traffic_fraction: {tile:.3f} tile-granular "
               f"(kernel reads), {elem:.3f} element-granular (ASIC model)")
    _print("sample tokens:", toks_h[0, :8].tolist())
    return toks_h


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _nccl_rank(rank: int, world: int, port: int, argv) -> None:
    """One process of ``--nccl``: card ``rank``, the world's NCCL group,
    the CLI's serving on this rank's shard."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        args = [a for a in argv if a != "--nccl"]
        main(args + ["--device", f"cuda:{rank}"])
    finally:
        dist.destroy_process_group()


def _spawn_nccl(args, argv) -> None:
    """``--nccl``: one process per rank of the mesh, each on its own card
    and a rank of one NCCL group (``models.sharding.DistGroup``):
    ``D*M`` processes for ``--mesh DxM``, one per visible card for
    ``--mesh host``."""
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import spec_shape

    if args.host_devices is not None:
        raise SystemExit("--nccl with --host-devices: choose one group")
    visible = torch.cuda.device_count()
    if args.mesh == "host":
        world = visible
    else:
        shape = spec_shape(args.mesh)
        if shape is None:
            raise SystemExit(f"--nccl needs --mesh host or DxM, got "
                             f"{args.mesh!r}")
        world = shape[0] * shape[1]
    if world < 2 or world > visible:
        raise SystemExit(f"--nccl --mesh {args.mesh}: {world} ranks, one a "
                         f"card, need two or more cards and at most the "
                         f"{visible} visible")
    mp.spawn(_nccl_rank, args=(world, _free_port(), argv), nprocs=world,
             join=True)


if __name__ == "__main__":
    main()
