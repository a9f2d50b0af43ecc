#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every CUDA kernel from ``src/repro_torch/kernels/*/
   csrc`` with ``nvcc`` (its time and ptxas' register report);
2. K1, the LOG2 quantizer, bit-equal to its plain version on the card: the
   main path's activation shapes in f32 and bf16 plus the special-value
   lattice, n_bits 2..8;
3. K2, the plane-skipping bit-plane GEMM, bit-equal to its plain version
   and to the direct-shift oracle on the card: every main-path (K, N) with
   M in {1, 4, 256}, extreme exponents, cold activations and a fully
   pruned tile;
4. full-width smollm-135m in bf16 (random weights from seed 0), batch 4,
   prompt 64, 32 new tokens through ``greedy_generate``: float, then
   quantized with stats, then quantized with packed planes.  Each kernel
   must launch 210 x 32 times in each quantized run (30 layers x 7
   projections x (1 prefill + 31 decode forwards)), packed tokens must
   equal unpacked ones, and on one decode step's real activations both
   kernels must equal their plain versions for every projection of every
   layer.  Then the smoke config in f32 on the card against the plain
   path on the host (tokens equal, logits close);
5. the kernels' time at the decode shapes (M = 4) on the real decode
   step's inputs, by CUDA-graph replay of one step's 210 launches, beside
   their plain versions, their bound (bytes over 3.35 TB/s) and, for K2,
   the bf16 ``torch.matmul`` of the same shapes as context.

Prints a ``kernels:`` line, the JSON kernel table and, last, the result
line ``{"ok": true, "device": {...}}``.  It imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
INT32_OPS_PER_S = 67e12             # CUDA-core 32-bit rate (f32 figure)
MAIN_KN = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
BATCH, PROMPT, NEW = 4, 64, 32
PROJ = ["wq", "wk", "wv", "wo", "gate", "up", "down"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def lattice(torch, seed: int = 0):
    """Special values, the sqrt(2) comparator's edge mantissas at many
    exponents and both signs, subnormals, random magnitudes (f32)."""
    specials = [0.0, -0.0, math.inf, -math.inf, math.nan, 1e-38, -1e-38,
                2.0 ** -8, 2.0 ** 7, 1.5, -1.5, 1.0, -1.0]
    fields = torch.arange(100, 160, dtype=torch.int32)
    edges = torch.cat([((fields << 23) | m).view(torch.float32)
                       for m in (3474675, 3474676)])
    subnormal = torch.tensor([1, 0x7FFFFF, 0x400000], dtype=torch.int32
                             ).view(torch.float32)
    g = torch.Generator().manual_seed(seed)
    rand = torch.randn(701, generator=g) * torch.exp2(
        torch.randint(-20, 20, (701,), generator=g).float())
    return torch.cat([torch.tensor(specials), edges, -edges, subnormal,
                      -subnormal, rand])


def sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device time of ``fn``'s work, by CUDA-graph replay (no host launch
    overhead), averaged over ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(torch, fn, reps: int = 5) -> float:
    """Time of ``fn`` issued from the host as the eager path issues it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not (REPO / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core.logquant import LogQuantized, log2_quantize
    from repro_torch.core.shiftadd import QuantCtx, shiftadd_matmul_bitplane
    from repro_torch.core.wquant import quantize_weights
    from repro_torch.core.bitplane import to_bitplanes
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitplane_matmul import ops as bm_ops
    from repro_torch.kernels.bitplane_matmul.ref import bitplane_matmul_ref
    from repro_torch.kernels.log2quant import ops as l2_ops
    from repro_torch.models.model import forward, init_caches, init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

    # -- phase 1: the card, the versions, the build -------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {name}, "
          f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    try:
        _build.build_all()
        l2_ops._lib()
        bm_ops._lib()
    except RuntimeError as e:
        fail(f"kernel build failed: {e}")
    print(f"phase 1: built {[p.name for p in _build.sources()]} in "
          f"{time.perf_counter() - t0:.1f} s")
    for stem in ("log2quant", "bitplane_matmul"):
        for line in _build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    # -- phase 2: K1 against its plain version ------------------------------
    g = torch.Generator(device=dev).manual_seed(1)
    k1_err = 0
    k1_checked = 0
    inputs = []
    for m in (1, BATCH, BATCH * PROMPT):
        for k in (576, 1536):
            x = torch.randn((m, k), generator=g, device=dev)
            inputs += [x, x.to(torch.bfloat16)]
    lat = lattice(torch).to(dev)
    inputs += [lat, lat.to(torch.bfloat16), lat.to(torch.float16), lat[1:],
               lat[3:].to(torch.bfloat16)]
    for x in inputs:
        for n_bits in range(2, 9):
            q = l2_ops.log2quant(x, n_bits)
            ref = log2_quantize(x, n_bits)
            bad = int((q.exp != ref.exp).sum() + (q.sign != ref.sign).sum())
            k1_err = max(k1_err, int((q.exp.int() - ref.exp.int()).abs()
                                     .max()),
                         int((q.sign.int() - ref.sign.int()).abs().max()))
            check(bad == 0, f"K1 differs from its plain version on "
                  f"{tuple(x.shape)} {x.dtype} n_bits={n_bits}: {bad}")
            k1_checked += 1
    torch.cuda.synchronize()
    print(f"phase 2: K1 bit-equal to its plain version in {k1_checked} "
          f"cases (f32/bf16/f16, n_bits 2..8, lattice + main-path shapes)")

    # -- phase 3: K2 against its plain version and the oracle ---------------
    def gemm_case(m, k, n, scale=1.0, zero_frac=0.1):
        x = torch.randn((m, k), generator=g, device=dev) * scale
        x[torch.rand((m, k), generator=g, device=dev) < zero_frac] = 0.0
        q = log2_quantize(x)
        w = quantize_weights(torch.randn((k, n), generator=g, device=dev)
                             * 0.05, channel_axis=-1)
        return q.exp, q.sign, to_bitplanes(w.q), w.q

    cases = []
    for k, n in MAIN_KN:
        for m in (1, BATCH, BATCH * PROMPT):
            cases.append((f"{m}x{k}x{n}", gemm_case(m, k, n)))
        cases.append((f"cold {BATCH}x{k}x{n}",
                      gemm_case(BATCH, k, n, scale=0.02)))
    x = torch.cat([torch.randn((32, 64), generator=g, device=dev) * 1e-3,
                   torch.randn((32, 64), generator=g, device=dev) * 100.0,
                   torch.zeros((32, 64), device=dev)], dim=1)
    q = log2_quantize(x)
    w = quantize_weights(torch.randn((192, 64), generator=g, device=dev)
                         * 0.1, channel_axis=-1)
    cases.append(("extreme exponents", (q.exp, q.sign, to_bitplanes(w.q),
                                        w.q)))
    q = log2_quantize(torch.zeros((128, 128), device=dev))
    ones = torch.ones((128, 128), dtype=torch.int8, device=dev)
    cases.append(("fully pruned tile", (q.exp, q.sign, to_bitplanes(ones),
                                        ones)))
    k2_err = 0
    for label, (exp, sign, planes, wq) in cases:
        y = bm_ops.bitplane_matmul(exp, sign, planes)
        plain = shiftadd_matmul_bitplane(LogQuantized(exp, sign), planes)
        oracle = bitplane_matmul_ref(exp, sign, wq)
        k2_err = max(k2_err, int((y.long() - plain.long()).abs().max()))
        check(k2_err == 0, f"K2 differs from its plain version ({label}): "
              f"max |diff| {k2_err}")
        check(torch.equal(y, oracle), f"K2 differs from the oracle ({label})")
    check(not bm_ops.bitplane_matmul(*cases[-1][1][:3]).any(),
          "K2 fully pruned tile is not zero")
    torch.cuda.synchronize()
    print(f"phase 3: K2 bit-equal to its plain version and the oracle in "
          f"{len(cases)} cases")

    # -- phase 4: full-width smollm-135m through greedy_generate ------------
    cfg = get_config("smollm-135m")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    per_run = cfg.n_layers * len(PROJ) * NEW
    print(f"phase 4: {cfg.name} {cfg.n_layers}L d={cfg.d_model} "
          f"{cfg.n_heads}H/{cfg.n_kv_heads}kv ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} {cfg.dtype}, batch {BATCH}, prompt "
          f"{PROMPT}, {NEW} new tokens")

    engine.greedy_generate(cfg, params, prompt, 2)           # warm-up
    l2_ops.log2quant.launches = bm_ops.bitplane_matmul.launches = 0
    toks_f, t_f = sync_time(torch, lambda: engine.greedy_generate(
        cfg, params, prompt, NEW))
    check(l2_ops.log2quant.launches == 0
          and bm_ops.bitplane_matmul.launches == 0,
          "the float path launched a quantized kernel")

    qparams = quantize_model_params(cfg, params)
    l2_ops.log2quant.launches = bm_ops.bitplane_matmul.launches = 0
    (toks_q, stats), t_q = sync_time(torch, lambda: engine.greedy_generate(
        cfg, qparams, prompt, NEW, quant=True, with_stats=True))
    launches = {"log2quant": l2_ops.log2quant.launches,
                "bitplane_matmul": bm_ops.bitplane_matmul.launches}
    for kname, count in launches.items():
        check(count == per_run, f"{kname} launched {count} times in the "
              f"quantized run, expected {per_run}")

    pparams = quantize_model_params(cfg, params, pack=True)
    l2_ops.log2quant.launches = bm_ops.bitplane_matmul.launches = 0
    toks_p, t_p = sync_time(torch, lambda: engine.greedy_generate(
        cfg, pparams, prompt, NEW, quant=True))
    for kname, count in (("log2quant", l2_ops.log2quant.launches),
                         ("bitplane_matmul",
                          bm_ops.bitplane_matmul.launches)):
        check(count == per_run, f"{kname} launched {count} times in the "
              f"packed run, expected {per_run}")
    check(torch.equal(toks_p, toks_q), "packed-plane tokens differ from "
          "unpacked")
    for toks in (toks_f, toks_q):
        check(toks.shape == (BATCH, NEW) and bool((toks >= 0).all())
              and bool((toks < cfg.vocab_size).all()), "bad token tensor")
    tile = stats["plane_traffic_fraction"].cpu()
    elem = stats["element_traffic_fraction"].cpu()
    check(bool((tile[:-1] > 0).all() and (tile[:-1] <= 1).all()
               and (elem[:-1] > 0).all() and (elem <= tile + 1e-6).all()
               and tile[-1] == 0), f"bad traffic stats {tile} {elem}")
    new = BATCH * NEW
    print(f"  float: {new} tokens in {t_f:.3f} s = {new / t_f:.1f} tok/s "
          f"(prefill + decode, eager)")
    print(f"  quant: {new} tokens in {t_q:.3f} s = {new / t_q:.1f} tok/s "
          f"(with stats); packed: {t_p:.3f} s = {new / t_p:.1f} tok/s")
    print(f"  launches per quantized run: {launches} "
          f"(= {cfg.n_layers} layers x {len(PROJ)} projections x {NEW} "
          f"forwards)")
    print(f"  plane traffic per decode step: tile "
          f"{float(tile[:-1].mean()):.6f}, element "
          f"{float(elem[:-1].mean()):.6f}")
    print(f"  quant tokens equal to float tokens: "
          f"{float((toks_q == toks_f).float().mean()):.4f} "
          f"(informational: 4-bit LOG2 activations change tokens)")
    print(f"  packed tokens equal unpacked: True")

    # one decode step's real activations, captured through QuantCtx
    caches = init_caches(cfg, BATCH, PROMPT + 1, device=dev)
    logits, caches = engine.make_prefill_step(cfg, True)(
        qparams, {"tokens": prompt}, caches)
    ctx = QuantCtx(capture=[])
    step_logits, _ = engine.make_serve_step(cfg, ctx)(
        qparams, caches, torch.argmax(logits, -1).to(torch.int32)[:, None])
    check(bool(torch.isfinite(logits.float()).all()
               and torch.isfinite(step_logits.float()).all()),
          "non-finite logits")
    check(len(ctx.capture) == cfg.n_layers * len(PROJ),
          f"captured {len(ctx.capture)} projections")
    for i, (xs, exp, sign, planes, y) in enumerate(ctx.capture):
        ref = log2_quantize(xs)
        check(torch.equal(exp, ref.exp) and torch.equal(sign, ref.sign),
              f"K1 differs from its plain version on layer {i // 7} "
              f"{PROJ[i % 7]}")
        check(torch.equal(y, shiftadd_matmul_bitplane(
            LogQuantized(exp, sign), planes)),
            f"K2 differs from its plain version on layer {i // 7} "
            f"{PROJ[i % 7]}")
    print(f"  decode step: K1 and K2 bit-equal to their plain versions on "
          f"all {len(ctx.capture)} projections' real activations")

    # the smoke config in f32: kernels on the card vs plain path on host
    scfg = get_smoke("smollm-135m").replace(dtype=torch.float32)
    sp_cpu = init_params(scfg, generator=torch.Generator().manual_seed(5),
                         device="cpu")
    sq_cpu = quantize_model_params(scfg, sp_cpu)
    sq_gpu = {"embed": sq_cpu["embed"].to(dev),
              "final_norm": sq_cpu["final_norm"].to(dev),
              "blocks": tuple(_to(torch, b, dev) for b in sq_cpu["blocks"])}
    sprompt = torch.randint(0, scfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(6),
                            dtype=torch.int32)
    for quant in (False, True):
        a = engine.greedy_generate(scfg, sq_cpu, sprompt, 8, quant=quant,
                                   device="cpu")
        b = engine.greedy_generate(scfg, sq_gpu, sprompt, 8, quant=quant)
        check(torch.equal(a, b.cpu()), f"smoke tokens (quant={quant}) on the "
              f"card differ from the host's plain path")
        la, _ = forward(scfg, sq_cpu, tokens=sprompt, quant=quant)
        lb, _ = forward(scfg, sq_gpu, tokens=sprompt.to(dev), quant=quant)
        err = float((la - lb.cpu()).abs().max())
        check(err <= 1e-4, f"smoke logits (quant={quant}) differ by {err}")
        print(f"  smoke f32 (quant={quant}): tokens equal the host's plain "
              f"path, logits max |diff| {err:.2e}")

    # -- phase 5: kernel times at the decode shapes -------------------------
    steps = ctx.capture                                  # 210 real calls
    planes_by_call = [c[3] for c in steps]

    def k1_step():
        for xs, *_ in steps:
            l2_ops.log2quant(xs)

    def k1_plain_step():
        for xs, *_ in steps:
            log2_quantize(xs)

    def k2_step():
        for _, exp, sign, planes, _ in steps:
            bm_ops.bitplane_matmul(exp, sign, planes)

    def k2_plain_step():
        for _, exp, sign, planes, _ in steps:
            shiftadd_matmul_bitplane(LogQuantized(exp, sign), planes)

    blk = params["blocks"][0]
    weights = [(blk[p] if p in ("wq", "wk", "wv", "wo") else blk["mlp"][p])
               for p in PROJ]
    acts = [torch.randn((BATCH, w.shape[1]), generator=g, device=dev,
                        dtype=torch.bfloat16) for w in weights]

    def matmul_step():
        for r in range(cfg.n_layers):
            for a, w in zip(acts, weights):
                torch.matmul(a, w[r])

    # bound: bytes each launch must move, summed over the step
    k1_bytes = sum(c[0].numel() * (c[0].element_size() + 2) for c in steps)
    k2_bytes = 0
    k2_ops = 0
    for xs, exp, sign, planes, _ in steps:
        m, k = exp.shape
        n = planes.shape[2]
        # plane bytes of the tiles the skip rule reads, each K tile 128
        # rows deep but the last, which holds k % 128
        table = bm_ops._skip_table(torch.nn.functional.pad(
            exp, (0, (-k) % 128, 0, (-m) % 128), value=-8), 128, 128, 4, 8)
        depth = torch.full((table.shape[1],), 128.0, device=dev)
        if k % 128:
            depth[-1] = k % 128
        k2_bytes += float(((8 - table).float() * depth).sum()) * n
        k2_bytes += m * k * 2 + m * n * 4
        k2_ops += 2 * m * k * n
    bound = {"log2quant": (k1_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
             "bitplane_matmul": (max(k2_bytes / HBM_BYTES_PER_S,
                                     k2_ops / INT32_OPS_PER_S) * 1e3,
                                 "bytes" if k2_bytes / HBM_BYTES_PER_S
                                 >= k2_ops / INT32_OPS_PER_S
                                 else "operations")}
    t = {
        "log2quant": (graph_ms(torch, k1_step), graph_ms(torch,
                                                          k1_plain_step),
                      eager_ms(torch, k1_step)),
        "bitplane_matmul": (graph_ms(torch, k2_step),
                            graph_ms(torch, k2_plain_step),
                            eager_ms(torch, k2_step)),
    }
    t_mm = graph_ms(torch, matmul_step)
    print(f"phase 5: one decode step (M = {BATCH}) = {len(steps)} launches "
          f"of each kernel on the step's real inputs, CUDA-graph replay, "
          f"on {card}")
    for kname in ("log2quant", "bitplane_matmul"):
        ms, plain, eager = t[kname]
        b_ms, b_by = bound[kname]
        print(f"  {kname}: {ms:.4f} ms per step ({ms / len(steps) * 1e3:.2f}"
              f" us per launch), plain {plain:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}), issued eagerly from the host {eager:.4f} ms")
    print(f"  context: bf16 torch.matmul of the same {len(steps)} (M,K)x(K,N)"
          f" shapes {t_mm:.4f} ms per step (the untruncated product, not "
          f"K2's function; the port never calls it)")
    per_shape = {}
    for (kk, nn) in MAIN_KN:
        sel = [c for c in steps if tuple(c[3].shape[1:]) == (kk, nn)]
        ms = graph_ms(torch, lambda sel=sel: [
            bm_ops.bitplane_matmul(c[1], c[2], c[3]) for c in sel])
        per_shape[f"{kk}x{nn}"] = ms / len(sel) * 1e3
    print("  K2 per launch by (K, N), us: "
          + ", ".join(f"{s} {v:.2f}" for s, v in per_shape.items()))

    table = []
    for kname, src, replaces, err in (
            ("log2quant", "src/repro_torch/kernels/log2quant/csrc/"
             "log2quant.cu", "src/repro/kernels/log2quant/kernel.py:65",
             k1_err),
            ("bitplane_matmul", "src/repro_torch/kernels/bitplane_matmul/"
             "csrc/bitplane_matmul.cu",
             "src/repro/kernels/bitplane_matmul/kernel.py:136", k2_err)):
        ms, plain, eager = t[kname]
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[kname],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": bound[kname][0], "bound_by": bound[kname][1],
                 "library_ms": None,
                 "scope": f"one decode step: {len(steps)} launches, M={BATCH}",
                 "eager_ms": eager}
        if kname == "bitplane_matmul":
            entry["context_matmul_ms"] = t_mm
        table.append(entry)
    print('kernels: ["log2quant", "bitplane_matmul"]')
    print(json.dumps({"kernels": table}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def _to(torch, tree, dev):
    """Move a params tree (dicts, QuantizedLinearParams, tensors) to dev."""
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(None if v is None else _to(torch, v, dev)
                            for v in tree))
    return tree.to(dev)


if __name__ == "__main__":
    main()
