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
   the bf16 ``torch.matmul`` of the same shapes as context;
6. K3, the paged-attention decode, against its plain version on the card:
   page_len {1, 4, 8} x (G, R) {(1,1), (2,2), (1,3)} x D {8, 16} plus
   smollm-135m's (3, 3, 64) at page_len 16, and the serving path's
   geometry (page_len 16, 32 table columns, lengths 512..0, so that every
   warp of a block walks several pages) at (G, R, D) (3, 3, 64), (3, 3,
   128) and (1, 8, 64), splits 1..4, f32 and bf16, at the reference's
   tolerances (f32 ``rtol=2e-5, atol=2e-6``; bf16 ``atol=2e-2``);
   trash-page poison of +-1e4 bitwise invisible on live rows, also at the
   serving geometry, length-0 rows finite; ``gather_traffic_counts`` on
   RAGGED512 exactly (57, 128);
7. the continuous-batching scheduler (``ServeScheduler``) serving
   full-width smollm-135m (random weights from seed 0) on a paged pool
   with the radix prefix cache: 8 slots, max_len 512, buckets 16..128,
   ticks of 8 steps, chunked "auto", page_len 16, split-KV 2, and a trace
   of 24 requests from seed 0 (8 prefix-free prompts of 16-128 tokens, 4
   of 200-400 tokens that take the chunked path, 8 that share a 96-token
   prefix with an earlier request, 4 of them 1-15 tokens more, which ends
   the hit inside a page: copy on write, and 4 exact repeats), 32 new
   tokens each.  In f32, the gather read and K3 give equal tokens for
   every request, float and quantized.  In bf16, K3 float and K3
   quantized with stats (the slice's main path: every count is set to 0
   just before it and read just after) report tok/s, wall time, launches
   (K3 = 30 x decode forwards; K1/K2 = 210 x forwards), prefix-cache
   stats and traffic fractions; on the tick that touches most pages, K3
   against its plain version for all 30 layers (real pool, tables and
   lengths, random queries), then its time by CUDA-graph replay of the
   step's 30 launches beside its bound (touched K/V pages, q and the
   partials over 3.35 TB/s), the plain version's time and, as context,
   ``_paged_gather`` + ``F.scaled_dot_product_attention`` on the same
   tables;
8. K4, the paged-attention decode over the log2-quantized pool, against
   its plain version on the card: phase 6's geometries and boundary
   lengths, the serving geometry included, n_bits {2, 4, 8}, q in f32 and
   bf16, splits 1..4, within f32 ``rtol=2e-5, atol=2e-6``, with random
   trash-page codes and scales (up to +-127) and a garbage tail ring
   bitwise invisible on live rows through
   ``paged_decode_attention_quant`` (also at the serving geometry), and
   no NaN;
9. the scheduler of phase 7 (model, trace, ``ServeConfig``) with
   ``kv_quant=True, kv_bits=4``.  In f32 with float projections, at the
   first 8 of the 30 layers (to keep the script's time), the
   quantized-gather read and K4: every K4 call within f32 tolerance of
   the dequantize-and-gather math on the same inputs, and tokens equal
   unless the two runs wrote a different K/V code.  In bf16 with
   ``quant=True`` (the slice's main path: K1, K2 and K4 on every decode
   step; every count is set to 0 just before it and read just after):
   tok/s, decode-only tok/s, hit rate, launches, the pool bytes per
   request of the reference bench's byte model; on the tick that touches
   most pages, K4 against its plain version for all 30 layers (rows of up
   to 372 tokens: the partial o held divided by its split's l), then its
   time by CUDA-graph replay of the step's 30 launches beside its bound
   (the full code pages it reads, their scales, q and the partials over
   3.35 TB/s), the plain version's time and two contexts: gathering the
   table's code pages and scales, dequantizing only those, then
   ``F.scaled_dot_product_attention`` (``library_ms``), and dequantizing
   the whole pool, then ``_paged_gather`` + the same SDPA.

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
F32_TOL = (2e-5, 2e-6)              # rtol, atol (tests/test_paged_attention)
BF16_TOL = (0.0, 2e-2)
SERVE = dict(max_slots=8, max_len=512, buckets=(16, 32, 64, 128),
             tick_steps=8, chunked="auto", paged=True, page_len=16,
             prefix_cache=True, attn_splits=2)
SERVE_NEW = 32
KV_BITS = 4
F32_KVQ_LAYERS = 8                  # depth of phase 9's f32 comparison
# phases 6 and 8 at the serving path's geometry (page_len 16, 32 table
# columns): rows long enough that every warp of a block walks several
# pages, at smollm-135m's (G, R, D) and at D = 128 and R = 8
LONG_LENGTHS = [512, 300, 64, 33, 17, 16, 1, 0]
LONG_GEOS = [(3, 3, 64), (3, 3, 128), (1, 8, 64)]


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
    t_main = time.perf_counter()
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
    from repro_torch.kernels.paged_attention import ops as pa_ops
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
        pa_ops._lib()
        pa_ops._lib_quant()
    except RuntimeError as e:
        fail(f"kernel build failed: {e}")
    print(f"phase 1: built {[p.name for p in _build.sources()]} in "
          f"{time.perf_counter() - t0:.1f} s")
    for stem in ("log2quant", "bitplane_matmul", "paged_attention",
                 "paged_attention_quant"):
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

    # -- phase 6: K3 against its plain version ------------------------------
    k3_err = phase6(torch, dev, pa_ops)

    # -- phase 7: the continuous-batching scheduler at full width -----------
    k3 = phase7(torch, dev, card, pa_ops, l2_ops, bm_ops)
    k3_err = max(k3_err, k3["max_abs_err"])
    print(f"  (phases 1-7 done at {time.perf_counter() - t_main:.0f} s)")

    # -- phase 8: K4 against its plain version ------------------------------
    k4_err = phase8(torch, dev, pa_ops)

    # -- phase 9: the scheduler with the quantized pool at full width -------
    k4 = phase9(torch, dev, card, pa_ops, l2_ops, bm_ops)
    k4_err = max(k4_err, k4["max_abs_err"])
    print(f"  (phases 8-9 done at {time.perf_counter() - t_main:.0f} s)")

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
    table.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:219",
        "launches": k3["launches"], "max_abs_err": k3_err, "ms": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
        "scope": k3["scope"], "eager_ms": k3["eager_ms"]})
    table.append({
        "name": "paged_attention_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_attention_quant.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:315",
        "launches": k4["launches"], "max_abs_err": k4_err, "ms": k4["ms"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": k4["library_ms"],
        "context_whole_pool_ms": k4["context_whole_pool_ms"],
        "scope": k4["scope"], "eager_ms": k4["eager_ms"]})
    print('kernels: ["log2quant", "bitplane_matmul", "paged_attention", '
          '"paged_attention_quant"]')
    print(json.dumps({"kernels": table}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def close(torch, out, ref, tol) -> float:
    """max |out - ref|; fails unless |out - ref| <= atol + rtol * |ref|."""
    rtol, atol = tol
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    err = float(diff.max()) if diff.numel() else 0.0
    return err if ok else -err


def paged_case(torch, dev, page_len, nb, g, r, d, lengths, dtype, poison,
               seed):
    """Pool + table laid out as the scheduler lays them out: each row's
    first ceil(len / page_len) entries name fresh pages, the rest the
    trash page 0, which holds ``poison``."""
    from repro_torch.kernels.paged_attention import ops as pa_ops

    gen = torch.Generator().manual_seed(seed)
    b = len(lengths)
    n_pages = 1 + b * nb
    k = torch.randn((n_pages, page_len, g, d), generator=gen)
    v = torch.randn((n_pages, page_len, g, d), generator=gen)
    k[0] = poison
    v[0] = poison
    table = torch.from_numpy(pa_ops.make_page_table(lengths, nb, page_len))
    q = torch.randn((b, g, r, d), generator=gen)
    return (q.to(dtype).to(dev), k.to(dtype).to(dev), v.to(dtype).to(dev),
            table.to(dev), torch.tensor(lengths, dtype=torch.int32,
                                        device=dev))


def partials(got, want, normalized):
    """(name, kernel, plain) for each f32 partial to hold at F32_TOL: m, l
    and o, or o divided by its split's l (``normalized``, rows of hundreds
    of tokens: there the unnormalised o's own f32 rounding exceeds atol,
    the plain version's by up to 4.7e-6 at D = 64 and 1.8e-5 at D = 128
    against exact f64 partials, so only a kernel that sums in its exact
    order could meet it)."""
    from repro_torch.kernels.paged_attention.ops import NEG_INF

    (o, m, l), (po, pm, pl) = got, want
    if not normalized:
        return (("o", o, po), ("m", m, pm), ("l", l, pl))
    held = pm > NEG_INF / 2
    return (("o / l", o[held] / l[held][:, None],
             po[held] / pl[held][:, None]), ("m", m, pm), ("l", l, pl))


def k3_against_plain(torch, pa_ops, qg, k, v, table, lens, splits, what,
                     normalized=False):
    """Kernel and plain partials of one call; returns the merged outputs'
    max |diff| (fails outside the dtype's tolerance)."""
    nb = table.shape[1]
    pt = torch.nn.functional.pad(table, (0, (-nb) % splits))
    o, m, l = pa_ops.paged_attention(qg, k, v, pt, lens, splits)
    po, pm, pl = pa_ops.paged_attention_plain(qg, k, v, pt, lens, splits)
    torch.cuda.synchronize()
    check(torch.equal(m <= pa_ops.NEG_INF / 2, pm <= pa_ops.NEG_INF / 2),
          f"K3 ({what}): the splits holding a valid token differ")
    f32 = qg.dtype == torch.float32
    if f32:
        for nm, a, e in partials((o, m, l), (po, pm, pl), normalized):
            check(close(torch, a, e, F32_TOL) >= 0,
                  f"K3 ({what}): partial {nm} outside f32 tolerance")
    out = pa_ops.merge_split_softmax(m, l, o, axis=2)
    ref = pa_ops.merge_split_softmax(pm, pl, po, axis=2)
    check(bool(torch.isfinite(out).all()), f"K3 ({what}): non-finite out")
    live = lens > 0
    err = close(torch, out[live], ref[live], F32_TOL if f32 else BF16_TOL)
    check(err >= 0, f"K3 ({what}): merged output differs from the plain "
          f"version by {-err}")
    return err


def phase6(torch, dev, pa_ops) -> float:
    geos = [(pl, nb, g, r, d) for pl, nb in ((1, 4), (4, 4), (8, 3))
            for g, r in ((1, 1), (2, 2), (1, 3)) for d in (8, 16)]
    geos.append((16, 8, 3, 3, 64))
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for i, (pl, nb, g, r, d) in enumerate(geos):
        mx = pl * nb
        lengths = [x for x in dict.fromkeys(
            [0, 1, pl - 1, pl, pl + 1, 2 * pl, mx]) if 0 <= x <= mx]
        for dtype in errs:
            q, k, v, table, lens = paged_case(torch, dev, pl, nb, g, r, d,
                                              lengths, dtype, 1e4, i)
            for splits in (1, 2, 3, 4):
                errs[dtype] = max(errs[dtype], k3_against_plain(
                    torch, pa_ops, q, k, v, table, lens, splits,
                    f"page_len {pl} G {g} R {r} D {d} {dtype} splits "
                    f"{splits}"))
                n += 1
    for i, (g, r, d) in enumerate(LONG_GEOS):
        for dtype in errs:
            q, k, v, table, lens = paged_case(torch, dev, 16, 32, g, r, d,
                                              LONG_LENGTHS, dtype, 1e4,
                                              200 + i)
            for splits in (1, 2, 3, 4):
                errs[dtype] = max(errs[dtype], k3_against_plain(
                    torch, pa_ops, q, k, v, table, lens, splits,
                    f"long rows G {g} R {r} D {d} {dtype} splits {splits}",
                    normalized=True))
                n += 1
    poisoned = 0
    # (page_len, nb, G, R, D, lengths, splits, seed): the boundary rows, then
    # the serving geometry's long rows
    poison_cases = [(pl, 4, g, r, d, [0, 1, 3, 4, 5, 16, 4 * pl], (1, 2, 3),
                     11) for pl, g, r, d in ((4, 2, 2, 8), (16, 3, 3, 64))]
    poison_cases.append((16, 32, 3, 3, 64, LONG_LENGTHS, (1, 2, 3, 4), 12))
    for dtype in errs:
        for pl, nb, g, r, d, lengths, split_set, seed in poison_cases:
            live = torch.tensor(lengths, device=dev) > 0
            for splits in split_set:
                outs = []
                for poison in (0.0, 1e4, -1e4):
                    q, k, v, table, lens = paged_case(
                        torch, dev, pl, nb, g, r, d, lengths, dtype, poison,
                        seed)
                    out = pa_ops.paged_decode_attention(
                        q.reshape(len(lengths), 1, g * r, d), k, v, table,
                        lens, splits=splits)
                    check(bool(torch.isfinite(out.float()).all()),
                          "K3: non-finite output under trash poison")
                    outs.append(out)
                for out in outs[1:]:
                    check(torch.equal(out[live], outs[0][live]),
                          f"K3: trash poison reached a live row ({dtype}, "
                          f"page_len {pl}, nb {nb}, splits {splits})")
                poisoned += 1
    geo = pa_ops.RAGGED512
    rag = pa_ops.make_page_table(geo["lengths"], geo["nb"], geo["page_len"])
    counts = pa_ops.gather_traffic_counts(rag, geo["lengths"],
                                          geo["page_len"])
    check(counts == (57.0, 128.0), f"RAGGED512 traffic {counts}")
    q, k, v, _, lens = paged_case(torch, dev, geo["page_len"], geo["nb"],
                                  geo["g"], geo["r"], geo["d"],
                                  list(geo["lengths"]), torch.float32, 0.0,
                                  512)
    for splits in (1, 4):
        errs[torch.float32] = max(errs[torch.float32], k3_against_plain(
            torch, pa_ops, q, k, v, torch.from_numpy(rag).to(dev), lens,
            splits, f"RAGGED512 splits {splits}"))
    print(f"phase 6: K3 within tolerance of its plain version in {n + 2} "
          f"cases (max |diff| f32 {errs[torch.float32]:.3e}, bf16 "
          f"{errs[torch.bfloat16]:.3e}); trash poison +-1e4 bitwise "
          f"invisible on live rows in {poisoned} cases; RAGGED512 touched/"
          f"total pages {counts[0]:.0f}/{counts[1]:.0f}")
    return max(errs.values())


def audited(torch, inner, audit):
    """``paged_decode_attention`` that also runs the dense-gather oracle
    (``kernels/paged_attention/ref.py``, op for op the gather read) on
    the same inputs: counts calls, keeps the max |diff| on the rows of
    slots holding pages, counts tolerance failures and those rows'
    elements whose LOG2 code (4 bits, as the next projection quantizes
    them) differs."""
    from repro_torch.core.logquant import log2_quantize
    from repro_torch.kernels.paged_attention.ref import \
        paged_attention_reference

    def call(q, k_pool, v_pool, page_table, lengths, *, splits=1):
        out = inner(q, k_pool, v_pool, page_table, lengths, splits=splits)
        ref = paged_attention_reference(q, k_pool, v_pool, page_table,
                                        lengths)
        # rows of slots that hold pages (a retired slot's table is all
        # trash; its row is junk nobody reads)
        live = (lengths > 0) & (page_table[:, 0] != 0)
        err = close(torch, out[live], ref[live], F32_TOL)
        audit["calls"] += 1
        audit["bad"] += err < 0
        audit["err"] = max(audit["err"], abs(err))
        a, e = log2_quantize(out[live].float()), log2_quantize(
            ref[live].float())
        audit["flips"] += int(((a.exp != e.exp) | (a.sign != e.sign)).sum())
        return out
    return call


def serve_trace(vocab: int):
    """24 requests from seed 0 (see the module docstring)."""
    import numpy as np

    rng = np.random.default_rng(0)

    def tok(n):
        return rng.integers(0, vocab, size=int(n)).astype(np.int32)

    # the first four are long enough to donate 7 whole pages
    free = [tok(n) for n in (112, 120, 128, 116)]
    free += [tok(n) for n in rng.integers(16, 129, size=4)]
    longs = [tok(n) for n in rng.integers(200, 401, size=4)]
    sharers = []
    for i in range(8):
        extra = int(rng.integers(1, 16)) if i % 2 else 0
        sharers.append(np.concatenate(
            [free[i % 4][:96 + extra], tok(rng.integers(5, 41))]))
    repeats = [free[j].copy() for j in (4, 5, 6, 7)]
    return free + longs + sharers + repeats


def serve(torch, dev, cfg, trace, *, quant, kernel, stats, counters,
          on_tick=None, kv_quant=False):
    """Serve the trace through ServeScheduler; returns (results, sched,
    forwards, wall seconds).  ``counters`` are zeroed just before the run;
    ``forwards`` counts the decode steps, chunk forwards and bucketed
    prefills the scheduler issued."""
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import ServeConfig, ServeScheduler

    params = init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    if quant:
        params = quantize_model_params(cfg, params)
    sc = ServeConfig(**SERVE, attn_kernel="pallas" if kernel else "off",
                     quant="pallas" if quant else False, with_stats=stats,
                     kv_quant=kv_quant, kv_bits=KV_BITS)
    sched = ServeScheduler(cfg, params, sc)
    fwd = {"decode": 0, "chunk": 0, "prefill": 0}

    def counted(fn, key):
        def call(*a):
            fwd[key] += 1
            return fn(*a)
        return call

    sched._step = counted(sched._step, "decode")
    sched._chunk_step = counted(sched._chunk_step, "chunk")
    sched._slot_prefill = counted(sched._slot_prefill, "prefill")
    for p in trace:
        sched.submit(p, max_new=SERVE_NEW)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    def generated():
        return (sum(len(sl.tokens) for sl in sched._slots if sl is not None)
                + sum(len(r.tokens) for r in sched._results.values()))

    # decode-only ticks (no admission prefill, no chunk): their tokens and
    # host-clock time (step_tick ends in the tick's one synchronisation)
    decode = {"tokens": 0, "s": 0.0, "ticks": 0}
    t0 = time.perf_counter()
    while sched.pending:
        before = (generated(), fwd["chunk"], fwd["prefill"])
        t1 = time.perf_counter()
        check(sched.step_tick(), "a tick found nothing to do")
        dt = time.perf_counter() - t1
        if before[1:] == (fwd["chunk"], fwd["prefill"]):
            decode["tokens"] += generated() - before[0]
            decode["s"] += dt
            decode["ticks"] += 1
        if on_tick is not None:
            on_tick(sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd["decode_only"] = decode
    results = sched.run()
    check(len(results) == len(trace), f"{len(results)} results")
    for r in results:
        check(r.finish_reason == "length" and len(r.tokens) == SERVE_NEW
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid}: {r.finish_reason}, {len(r.tokens)} tokens")
    return results, sched, fwd, wall


def phase7(torch, dev, card, pa_ops, l2_ops, bm_ops) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.attention import _paged_gather

    cfg = get_config("smollm-135m")
    trace = serve_trace(cfg.vocab_size)
    kernels = (pa_ops.paged_attention, l2_ops.log2quant,
               bm_ops.bitplane_matmul)
    print(f"phase 7: ServeScheduler, {cfg.name} full width, {SERVE}, "
          f"{len(trace)} requests (prompts "
          f"{min(len(p) for p in trace)}-{max(len(p) for p in trace)} "
          f"tokens), {SERVE_NEW} new tokens each")

    # f32: the gather read and K3, float and quantized.  Every K3 call of
    # the K3 runs is also held against the dense-gather oracle on the same
    # inputs (the gather path's own arithmetic); the LOG2 codes of the two
    # outputs — what the quantized path's wo projection reads next — are
    # compared too
    c32 = cfg.replace(dtype=torch.float32)
    for quant in (False, True):
        toks = {}
        for kernel in (False, True):
            audit = {"calls": 0, "err": 0.0, "bad": 0, "flips": 0}
            inner = pa_ops.paged_decode_attention
            if kernel:
                pa_ops.paged_decode_attention = audited(torch, inner, audit)
            try:
                res, _, fwd, wall = serve(torch, dev, c32, trace,
                                          quant=quant, kernel=kernel,
                                          stats=False, counters=kernels)
            finally:
                pa_ops.paged_decode_attention = inner
            want = cfg.n_layers * fwd["decode"] if kernel else 0
            check(pa_ops.paged_attention.launches == want,
                  f"K3 launched {pa_ops.paged_attention.launches} times, "
                  f"expected {want}")
            check(audit["calls"] == want and audit["bad"] == 0,
                  f"K3 against the gather oracle: {audit}")
            toks[kernel] = [r.tokens for r in res]
            fwd.pop("decode_only")
            print(f"  f32 {'quant' if quant else 'float'} "
                  f"{'K3' if kernel else 'gather'}: {wall:.3f} s, {fwd}"
                  + (f"; every K3 call within f32 tolerance of the gather "
                     f"oracle ({audit['calls']} calls, max |diff| "
                     f"{audit['err']:.3e}), LOG2 codes of the output "
                     f"differing on live rows: {audit['flips']}"
                     if kernel else ""))
        same = [a == b for a, b in zip(toks[False], toks[True])]
        first = [next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                 for a, b in zip(toks[False], toks[True]) if a != b]
        tag = "quant" if quant else "float"
        print(f"  f32 {tag}: K3 tokens equal the gather's for {sum(same)}/"
              f"{len(trace)} requests"
              + (f" (first differing token at {first})" if first else ""))
        # float: equal tokens.  Quantized: equal tokens unless a LOG2 code
        # of an attention output differs between K3 and the gather math;
        # the codes being equal everywhere makes the two runs identical
        check(all(same) or (quant and audit["flips"] > 0),
              f"f32 {tag}: K3 tokens differ from the gather's for "
              f"{len(trace) - sum(same)} requests with no LOG2 code of an "
              f"attention output differing")

    # bf16 K3 float, then the main path: K3 quantized with stats
    best = {"touched": -1}

    def on_tick(sched):
        lens = sched._pool["length"].cpu() + 1
        touched = int(((lens + 15) // 16).sum())
        if touched > best["touched"]:
            best.update(touched=touched, lens=lens.to(dev),
                        table=torch.from_numpy(sched._table.copy()).to(dev),
                        k=sched._pool["layers"][0]["k"].clone(),
                        v=sched._pool["layers"][0]["v"].clone())

    out = {}
    for quant in (False, True):
        res, sched, fwd, wall = serve(
            torch, dev, cfg, trace, quant=quant, kernel=True, stats=quant,
            counters=kernels, on_tick=on_tick if quant else None)
        launches = {k.__name__: k.launches for k in kernels}
        dec = fwd.pop("decode_only")
        per_fwd = cfg.n_layers * len(PROJ)
        n_fwd = sum(fwd.values())
        check(launches["paged_attention"] == cfg.n_layers * fwd["decode"],
              f"K3 launches {launches['paged_attention']} != "
              f"{cfg.n_layers} x {fwd['decode']} decode forwards")
        if quant:
            for kn in ("log2quant", "bitplane_matmul"):
                check(launches[kn] == per_fwd * n_fwd,
                      f"{kn} launched {launches[kn]} times, expected "
                      f"{per_fwd} x {n_fwd} forwards")
        else:
            check(launches["log2quant"] == launches["bitplane_matmul"] == 0,
                  "the float run launched a quantized kernel")
        total = sum(len(r.tokens) for r in res)
        st = sched.prefix_cache_stats()
        check(st["cached_tokens"] > 0 and st["cached_tokens"] % 16 != 0,
              f"prefix cache stats {st}: expected whole-page and "
              f"copy-on-write hits")
        tag = "quant+stats" if quant else "float"
        print(f"  bf16 {tag} K3: {total} tokens in {wall:.3f} s = "
              f"{total / wall:.1f} tok/s (prefill included, eager); "
              f"decode-only ticks: {dec['tokens']} tokens in "
              f"{dec['s']:.3f} s = {dec['tokens'] / max(dec['s'], 1e-9):.1f}"
              f" tok/s over {dec['ticks']} ticks; forwards {fwd}; launches "
              f"{launches}")
        print(f"    prefix cache: hit_rate {st['hit_rate']:.6f}, "
              f"cached_tokens {st['cached_tokens']:.0f}/"
              f"{st['prompt_tokens']:.0f}, lookups hit "
              f"{st['lookup_hits']:.0f}/{st['lookups']:.0f}, pages_in_use "
              f"{st['pages_in_use']:.0f}")
        if quant:
            tile = sum(r.plane_traffic_fraction for r in res) / len(res)
            elem = sum(r.element_traffic_fraction for r in res) / len(res)
            check(0 < elem <= tile <= 1, f"traffic fractions {tile} {elem}")
            print(f"    mean per-request plane_traffic_fraction {tile:.6f}, "
                  f"element_traffic_fraction {elem:.6f}")
            out["launches"] = launches["paged_attention"]

    # K3 on the tick that touched most pages: real pool, table, lengths
    lens, table = best["lens"].to(torch.int32), best["table"]
    b, nb = table.shape
    g, d = cfg.n_kv_heads, cfg.head_dim
    r = cfg.n_heads // g
    splits = SERVE["attn_splits"]
    gen = torch.Generator(device=dev).manual_seed(7)
    qs = [torch.randn((b, g, r, d), generator=gen, device=dev,
                      dtype=cfg.dtype) for _ in range(cfg.n_layers)]
    err = 0.0
    for layer in range(cfg.n_layers):
        err = max(err, k3_against_plain(
            torch, pa_ops, qs[layer], best["k"][layer], best["v"][layer],
            table, lens, splits, f"full-width tick, layer {layer}"))
    print(f"  tick with {best['touched']} touched pages (lengths "
          f"{lens.tolist()}): K3 within bf16 tolerance of its plain version "
          f"on all {cfg.n_layers} layers (max |diff| {err:.3e})")

    def k3_step():
        for layer in range(cfg.n_layers):
            pa_ops.paged_attention(qs[layer], best["k"][layer],
                                   best["v"][layer], table, lens, splits)

    def plain_step():
        for layer in range(cfg.n_layers):
            pa_ops.paged_attention_plain(qs[layer], best["k"][layer],
                                         best["v"][layer], table, lens,
                                         splits)

    valid = (torch.arange(nb * SERVE["page_len"], device=dev)[None]
             < lens[:, None])[:, None, None, :]          # (B, 1, 1, S)

    def library_step():
        for layer in range(cfg.n_layers):
            kg = _paged_gather(best["k"][layer], table).transpose(1, 2)
            vg = _paged_gather(best["v"][layer], table).transpose(1, 2)
            torch.nn.functional.scaled_dot_product_attention(
                qs[layer].reshape(b, g * r, 1, d), kg, vg, attn_mask=valid,
                enable_gqa=True)

    ms, plain_ms = graph_ms(torch, k3_step), graph_ms(torch, plain_step)
    lib_ms = graph_ms(torch, library_step)
    eager = eager_ms(torch, k3_step)
    esz = torch.tensor([], dtype=cfg.dtype).element_size()
    touched = int(((lens.cpu() + SERVE["page_len"] - 1)
                   // SERVE["page_len"]).sum())
    kv_bytes = touched * SERVE["page_len"] * g * d * 2 * esz
    io_bytes = (b * g * r * d * esz + b * g * splits * r * (d + 2) * 4
                + b * nb * 4 + b * 4)
    step_bytes = cfg.n_layers * (kv_bytes + io_bytes)
    step_ops = cfg.n_layers * 4 * g * r * d * int(lens.sum())
    t_bytes = step_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = step_ops / INT32_OPS_PER_S * 1e3
    print(f"  K3 per decode step ({cfg.n_layers} launches, B={b}, "
          f"splits {splits}), CUDA-graph replay on {card}: {ms:.4f} ms "
          f"({ms / cfg.n_layers * 1e3:.2f} us per launch); bound "
          f"{max(t_bytes, t_ops):.5f} ms ({step_bytes} bytes: {touched} "
          f"touched pages x {SERVE['page_len']} tokens x {g * d * 2 * esz} "
          f"B per layer + q + partials); plain {plain_ms:.4f} ms; issued eagerly "
          f"{eager:.4f} ms; context: _paged_gather + "
          f"scaled_dot_product_attention {lib_ms:.4f} ms (the port never "
          f"calls it)")
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=lib_ms, eager_ms=eager, max_abs_err=err,
               scope=f"one decode step: {cfg.n_layers} launches, B={b}, "
                     f"{touched} touched pages, splits {splits}")
    return out


def quant_case(torch, dev, page_len, nb, g, r, d, lengths, n_bits, q_dtype,
               seed, garbage):
    """A quantized pool laid out as the scheduler lays it out (codes under
    each page's first-row scale) and a tail ring whose active half holds
    each row's newest page exactly; the trash page's codes and scales (up
    to +-127), the ring's other rows and its junk bin are garbage drawn
    from ``garbage``."""
    from repro_torch.core.logquant import quantize_page_codes, scale_exponent
    from repro_torch.kernels.paged_attention import ops as pa_ops

    gen = torch.Generator().manual_seed(seed)
    b = len(lengths)
    n_pages = 1 + b * nb
    table = torch.from_numpy(pa_ops.make_page_table(lengths, nb, page_len))
    q = torch.randn((b, g, r, d), generator=gen).to(q_dtype)
    junk = torch.Generator().manual_seed(1000 + garbage)
    out = [q]
    for _ in ("k", "v"):
        x = torch.randn((n_pages, page_len, g, d), generator=gen)
        se = scale_exponent(x[:, 0], dim=-1)                   # (P, G)
        codes = quantize_page_codes(x, se[:, None, :, None], n_bits)
        lim = 256 if n_bits >= 8 else 128
        codes[0] = torch.randint(-lim, lim, codes[0].shape,
                                 generator=junk).to(codes.dtype)
        se[0] = torch.randint(-127, 128, se[0].shape, generator=junk)
        tail = torch.randn((b, 2 * page_len + 1, g, d), generator=junk) * 1e3
        for i, n in enumerate(lengths):
            tb = max(n - 1, 0) // page_len
            if table[i, tb]:
                half = (tb % 2) * page_len
                tail[i, half:half + page_len] = x[table[i, tb]]
        out += [codes, se, tail]
    q, kc, ks, kt, vc, vs, vt = out
    lens = torch.tensor(lengths, dtype=torch.int32)
    return tuple(t.to(dev) for t in (q, kc, ks, vc, vs, kt, vt, table, lens))


def k4_against_plain(torch, pa_ops, qg, kc, ks, vc, vs, table, lens, n_bits,
                     splits, what, normalized=False):
    """K4 and plain partials of one call within f32 tolerance, merged
    outputs too on live rows, no NaN; returns the merged max |diff|."""
    nb = table.shape[1]
    pt = torch.nn.functional.pad(table, (0, (-nb) % splits))
    o, m, l = pa_ops.paged_attention_quant(qg, kc, ks, vc, vs, pt, lens,
                                           n_bits, splits)
    po, pm, pl = pa_ops.paged_attention_quant_plain(qg, kc, ks, vc, vs, pt,
                                                    lens, n_bits, splits)
    torch.cuda.synchronize()
    check(torch.equal(m <= pa_ops.NEG_INF / 2, pm <= pa_ops.NEG_INF / 2),
          f"K4 ({what}): the splits holding a valid token differ")
    for nm, a, e in partials((o, m, l), (po, pm, pl), normalized):
        check(close(torch, a, e, F32_TOL) >= 0,
              f"K4 ({what}): partial {nm} outside f32 tolerance")
    out = pa_ops.merge_split_softmax(m, l, o, axis=2)
    ref = pa_ops.merge_split_softmax(pm, pl, po, axis=2)
    check(not bool(torch.isnan(out).any()), f"K4 ({what}): NaN output")
    live = lens > 0
    err = close(torch, out[live], ref[live], F32_TOL)
    check(err >= 0, f"K4 ({what}): merged output differs from the plain "
          f"version by {-err}")
    return err


def phase8(torch, dev, pa_ops) -> float:
    geos = [(pl, nb, g, r, d) for pl, nb in ((1, 4), (4, 4), (8, 3))
            for g, r in ((1, 1), (2, 2), (1, 3)) for d in (8, 16)]
    geos.append((16, 8, 3, 3, 64))
    err, n = 0.0, 0
    for i, (pl, nb, g, r, d) in enumerate(geos):
        mx = pl * nb
        lengths = [x for x in dict.fromkeys(
            [0, 1, pl - 1, pl, pl + 1, 2 * pl, mx]) if 0 <= x <= mx]
        for n_bits in (2, 4, 8):
            for dtype in (torch.float32, torch.bfloat16):
                q, kc, ks, vc, vs, _, _, table, lens = quant_case(
                    torch, dev, pl, nb, g, r, d, lengths, n_bits, dtype,
                    100 + i, 0)
                for splits in (1, 2, 3, 4):
                    err = max(err, k4_against_plain(
                        torch, pa_ops, q, kc, ks, vc, vs, table, lens,
                        n_bits, splits, f"page_len {pl} G {g} R {r} D {d} "
                        f"n_bits {n_bits} {dtype} splits {splits}"))
                    n += 1
    for i, (g, r, d) in enumerate(LONG_GEOS):
        for n_bits in (2, 4, 8):
            for dtype in (torch.float32, torch.bfloat16):
                q, kc, ks, vc, vs, _, _, table, lens = quant_case(
                    torch, dev, 16, 32, g, r, d, LONG_LENGTHS, n_bits,
                    dtype, 300 + i, 0)
                for splits in (1, 2, 3, 4):
                    err = max(err, k4_against_plain(
                        torch, pa_ops, q, kc, ks, vc, vs, table, lens,
                        n_bits, splits, f"long rows G {g} R {r} D {d} "
                        f"n_bits {n_bits} {dtype} splits {splits}",
                        normalized=True))
                    n += 1
    garbage_cases = 0
    # (page_len, nb, G, R, D, lengths, q dtypes, seed): the boundary rows,
    # then the serving geometry's long rows
    both = (torch.float32, torch.bfloat16)
    garbage_geos = [(pl, 4, g, r, d, [0, 1, pl - 1, pl, pl + 1, 3 * pl], both,
                     7) for pl, g, r, d in ((4, 2, 2, 8), (16, 3, 3, 64))]
    garbage_geos.append((16, 32, 3, 3, 64, LONG_LENGTHS, (torch.bfloat16,),
                         8))
    for n_bits in (2, 4, 8):
        for pl, nb, g, r, d, lengths, dtypes, seed in garbage_geos:
            live = torch.tensor(lengths, device=dev) > 0
            for dtype in dtypes:
                for splits in (1, 2, 3, 4):
                    outs = []
                    for garbage in (0, 1, 2):
                        q, *rest = quant_case(torch, dev, pl, nb, g, r, d,
                                              lengths, n_bits, dtype, seed,
                                              garbage)
                        out = pa_ops.paged_decode_attention_quant(
                            q.reshape(len(lengths), 1, g * r, d), *rest,
                            n_bits=n_bits, splits=splits)
                        check(not bool(torch.isnan(out.float()).any()),
                              "K4: NaN output under garbage")
                        outs.append(out)
                    for out in outs[1:]:
                        check(torch.equal(out[live], outs[0][live]),
                              f"K4: garbage reached a live row (n_bits "
                              f"{n_bits}, {dtype}, page_len {pl}, nb {nb}, "
                              f"splits {splits})")
                    garbage_cases += 1
    print(f"phase 8: K4 within f32 tolerance of its plain version in {n} "
          f"cases (n_bits 2/4/8, q f32/bf16, splits 1-4, max |diff| "
          f"{err:.3e}); trash-page codes/scales and tail-ring garbage "
          f"bitwise invisible on live rows, no NaN, in {garbage_cases} "
          f"cases")
    return err


def audited_quant(torch, inner, audit):
    """``paged_decode_attention_quant`` that also computes the quantized
    gather read (``_quant_paged_gather`` + ``_decode_attention``, the
    dequantize-and-gather math of the gather path) on the same inputs:
    counts calls, keeps the max |diff| on the rows of slots holding pages
    and counts tolerance failures."""
    from repro_torch.models.attention import (_decode_attention,
                                              _quant_paged_gather)

    def call(q, kc, ks, vc, vs, kt, vt, table, lengths, *, n_bits=4,
             splits=1):
        out = inner(q, kc, ks, vc, vs, kt, vt, table, lengths, n_bits=n_bits,
                    splits=splits)
        kg = _quant_paged_gather(kc, ks, kt, table, lengths, n_bits, kt.dtype)
        vg = _quant_paged_gather(vc, vs, vt, table, lengths, n_bits, vt.dtype)
        kv_pos = torch.arange(kg.shape[1], dtype=torch.int32,
                              device=q.device).expand(q.shape[0], -1)
        ref = _decode_attention(q, kg, vg, (lengths - 1)[:, None], kv_pos,
                                lengths)
        live = (lengths > 0) & (table[:, 0] != 0)
        err = close(torch, out[live], ref[live], F32_TOL)
        audit["calls"] += 1
        audit["bad"] += err < 0
        audit["err"] = max(audit["err"], abs(err))
        return out
    return call


def code_digests(torch, attn, digests):
    """``_quant_paged_write`` that also keeps, per call, a weighted sum of
    the code pool without the trash page (on the device): two runs wrote
    the same codes in the same order iff their digests agree (up to a
    collision)."""
    inner = attn._quant_paged_write
    weights = {}

    def write(codes, *args):
        inner(codes, *args)
        flat = codes[1:].reshape(-1)
        w = weights.get(flat.numel())
        if w is None:
            w = weights[flat.numel()] = torch.arange(
                flat.numel(), device=flat.device) % 65521 + 1
        digests.append((flat.long() * w).sum())
    return write


def phase9(torch, dev, card, pa_ops, l2_ops, bm_ops) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.logquant import dequantize_page_codes
    from repro_torch.models import attention as attn
    from repro_torch.serving.kvpool import (blocks_for_tokens, page_kv_bytes,
                                            tail_ring_bytes)

    cfg = get_config("smollm-135m")
    trace = serve_trace(cfg.vocab_size)
    pl, splits = SERVE["page_len"], SERVE["attn_splits"]
    kernels = (pa_ops.paged_attention, pa_ops.paged_attention_quant,
               l2_ops.log2quant, bm_ops.bitplane_matmul)
    print(f"phase 9: ServeScheduler as phase 7 with kv_quant=True, "
          f"kv_bits={KV_BITS}")

    # f32, float projections, cut in depth: the quantized-gather read and K4
    c32 = cfg.replace(dtype=torch.float32, n_layers=F32_KVQ_LAYERS)
    toks, digests = {}, {}
    inner_attn, inner_write = (pa_ops.paged_decode_attention_quant,
                               attn._quant_paged_write)
    for kernel in (False, True):
        audit = {"calls": 0, "err": 0.0, "bad": 0}
        digests[kernel] = []
        attn._quant_paged_write = code_digests(torch, attn, digests[kernel])
        if kernel:
            pa_ops.paged_decode_attention_quant = audited_quant(
                torch, inner_attn, audit)
        try:
            res, _, fwd, wall = serve(torch, dev, c32, trace, quant=False,
                                      kernel=kernel, stats=False,
                                      counters=kernels, kv_quant=True)
        finally:
            pa_ops.paged_decode_attention_quant = inner_attn
            attn._quant_paged_write = inner_write
        want = c32.n_layers * fwd["decode"] if kernel else 0
        check(pa_ops.paged_attention_quant.launches == want
              and pa_ops.paged_attention.launches == 0,
              f"K4 launched {pa_ops.paged_attention_quant.launches} times "
              f"(K3 {pa_ops.paged_attention.launches}), expected {want}")
        check(audit["calls"] == want and audit["bad"] == 0,
              f"K4 against the quantized gather: {audit}")
        toks[kernel] = [r.tokens for r in res]
        fwd.pop("decode_only")
        print(f"  f32 float kv_quant, {c32.n_layers} layers, "
              f"{'K4' if kernel else 'gather'}: "
              f"{wall:.3f} s, {fwd}"
              + (f"; every K4 call within f32 tolerance of the quantized "
                 f"gather math ({audit['calls']} calls, max |diff| "
                 f"{audit['err']:.3e})" if kernel else ""))
    same = [a == b for a, b in zip(toks[False], toks[True])]
    d0, d1 = (torch.stack(digests[k]).cpu() for k in (False, True))
    codes_same = d0.shape == d1.shape and bool(torch.equal(d0, d1))
    first = (None if codes_same else
             int((d0[:len(d1)] != d1[:len(d0)]).nonzero()[0, 0]))
    print(f"  f32 kv_quant: K4 tokens equal the gather's for {sum(same)}/"
          f"{len(trace)} requests; the two runs wrote "
          + ("the same K/V codes in every write" if codes_same else
             f"a different K/V code first in pool write {first} of "
             f"{len(d0)}"))
    check(all(same) or not codes_same,
          f"f32 kv_quant: K4 tokens differ from the gather's for "
          f"{len(trace) - sum(same)} requests with every K/V code written "
          f"equal")

    # bf16, quant=True, K4: the slice's main path
    best = {"touched": -1}

    def on_tick(sched):
        lens = sched._pool["length"].cpu() + 1
        touched = int(((lens - 1) // pl).sum())
        if touched > best["touched"]:
            layer = sched._pool["layers"][0]
            best.update(touched=touched, lens=lens.to(dev),
                        table=torch.from_numpy(sched._table.copy()).to(dev),
                        **{k: layer[k].clone() for k in (
                            "k_codes", "k_scale", "v_codes", "v_scale")})

    res, sched, fwd, wall = serve(torch, dev, cfg, trace, quant=True,
                                  kernel=True, stats=False, counters=kernels,
                                  on_tick=on_tick, kv_quant=True)
    launches = {k.__name__: k.launches for k in kernels}
    dec = fwd.pop("decode_only")
    n_fwd = sum(fwd.values())
    check(launches["paged_attention_quant"] == cfg.n_layers * fwd["decode"]
          and launches["paged_attention"] == 0,
          f"K4 launches {launches} != {cfg.n_layers} x {fwd['decode']} "
          f"decode forwards")
    for kn in ("log2quant", "bitplane_matmul"):
        check(launches[kn] == cfg.n_layers * len(PROJ) * n_fwd,
              f"{kn} launched {launches[kn]} times, expected "
              f"{cfg.n_layers * len(PROJ)} x {n_fwd} forwards")
    total = sum(len(r.tokens) for r in res)
    st = sched.prefix_cache_stats()
    check(st["cached_tokens"] > 0 and st["cached_tokens"] % pl != 0,
          f"prefix cache stats {st}: expected whole-page and copy-on-write "
          f"hits")
    print(f"  bf16 quant kv_quant K4: {total} tokens in {wall:.3f} s = "
          f"{total / wall:.1f} tok/s (prefill included, eager); decode-only "
          f"ticks: {dec['tokens']} tokens in {dec['s']:.3f} s = "
          f"{dec['tokens'] / max(dec['s'], 1e-9):.1f} tok/s over "
          f"{dec['ticks']} ticks; forwards {fwd}; launches {launches}")
    print(f"    prefix cache: hit_rate {st['hit_rate']:.6f}, cached_tokens "
          f"{st['cached_tokens']:.0f}/{st['prompt_tokens']:.0f}, lookups hit "
          f"{st['lookup_hits']:.0f}/{st['lookups']:.0f}, pages_in_use "
          f"{st['pages_in_use']:.0f}")

    # pool bytes: the reference bench's byte model (f32 dense pages and
    # tail rings), machine-independent
    g, d = cfg.n_kv_heads, cfg.head_dim
    pages = sum(blocks_for_tokens(p.size + SERVE_NEW, pl) for p in trace)
    dense = pages * page_kv_bytes(pl, g, d, layers=cfg.n_layers)
    ring = tail_ring_bytes(pl, g, d, layers=cfg.n_layers)
    qpool = (pages * page_kv_bytes(pl, g, d, layers=cfg.n_layers, quant=True,
                                   kv_bits=KV_BITS)
             + SERVE["max_slots"] * ring)
    print(f"    pool bytes per request: dense {dense / len(trace):.1f}, "
          f"quantized {qpool / len(trace):.1f}; pool_bytes_saved_frac "
          f"{1 - qpool / dense:.6f}; tail_ring_bytes_per_slot {ring} "
          f"({pages} pages)")

    # K4 on the tick that touched most full pages: real pool, table, lengths
    lens, table = best["lens"].to(torch.int32), best["table"]
    kern_lens = ((lens - 1).clamp(min=0) // pl * pl).to(torch.int32)
    b, nb = table.shape
    r = cfg.n_heads // g
    gen = torch.Generator(device=dev).manual_seed(9)
    qs = [torch.randn((b, g, r, d), generator=gen, device=dev,
                      dtype=cfg.dtype) for _ in range(cfg.n_layers)]
    pool = [(best["k_codes"][i], best["k_scale"][i], best["v_codes"][i],
             best["v_scale"][i]) for i in range(cfg.n_layers)]
    err = 0.0
    for layer in range(cfg.n_layers):
        # rows of up to 372 tokens: o held divided by its split's l, as
        # phase 8's long rows are (see partials())
        err = max(err, k4_against_plain(
            torch, pa_ops, qs[layer], *pool[layer], table, kern_lens,
            KV_BITS, splits, f"full-width tick, layer {layer}",
            normalized=True))
    print(f"  tick with {best['touched']} full pages (lengths "
          f"{lens.tolist()}): K4 within f32 tolerance of its plain version "
          f"on all {cfg.n_layers} layers (max |diff| {err:.3e})")

    def k4_step():
        for layer in range(cfg.n_layers):
            pa_ops.paged_attention_quant(qs[layer], *pool[layer], table,
                                         kern_lens, KV_BITS, splits)

    def plain_step():
        for layer in range(cfg.n_layers):
            pa_ops.paged_attention_quant_plain(qs[layer], *pool[layer], table,
                                               kern_lens, KV_BITS, splits)

    valid = (torch.arange(nb * pl, device=dev)[None]
             < kern_lens[:, None])[:, None, None, :]      # (B, 1, 1, S)

    tl = table.long()

    def library_step():
        # the fair context: gather the table's code pages and scales, then
        # dequantize only those, then SDPA over the gathered view
        for layer in range(cfg.n_layers):
            kc, ks, vc, vs = pool[layer]
            kp = dequantize_page_codes(kc[tl], ks[tl][:, :, None, :, None],
                                       KV_BITS, cfg.dtype)
            vp = dequantize_page_codes(vc[tl], vs[tl][:, :, None, :, None],
                                       KV_BITS, cfg.dtype)
            kg = kp.reshape(b, nb * pl, g, d).transpose(1, 2)
            vg = vp.reshape(b, nb * pl, g, d).transpose(1, 2)
            torch.nn.functional.scaled_dot_product_attention(
                qs[layer].reshape(b, g * r, 1, d), kg, vg, attn_mask=valid,
                enable_gqa=True)

    def whole_pool_step():
        # PR 15's context: dequantize the whole pool, then gather + SDPA
        for layer in range(cfg.n_layers):
            kc, ks, vc, vs = pool[layer]
            kp = dequantize_page_codes(kc, ks[:, None, :, None], KV_BITS,
                                       cfg.dtype)
            vp = dequantize_page_codes(vc, vs[:, None, :, None], KV_BITS,
                                       cfg.dtype)
            kg = attn._paged_gather(kp, table).transpose(1, 2)
            vg = attn._paged_gather(vp, table).transpose(1, 2)
            torch.nn.functional.scaled_dot_product_attention(
                qs[layer].reshape(b, g * r, 1, d), kg, vg, attn_mask=valid,
                enable_gqa=True)

    ms, plain_ms = graph_ms(torch, k4_step), graph_ms(torch, plain_step)
    lib_ms = graph_ms(torch, library_step)
    pool_ms = graph_ms(torch, whole_pool_step)
    eager = eager_ms(torch, k4_step)
    esz = torch.tensor([], dtype=cfg.dtype).element_size()
    csz = best["k_codes"].element_size()
    full = int((kern_lens // pl).sum())
    page_bytes = pl * g * d * csz * 2 + g * 4 * 2     # K and V codes, scales
    io_bytes = (b * g * r * d * esz + b * g * splits * r * (d + 2) * 4
                + b * nb * 4 + b * 4)
    step_bytes = cfg.n_layers * (full * page_bytes + io_bytes)
    step_ops = cfg.n_layers * 4 * g * r * d * int(kern_lens.sum())
    t_bytes = step_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = step_ops / INT32_OPS_PER_S * 1e3
    print(f"  K4 per decode step ({cfg.n_layers} launches, B={b}, splits "
          f"{splits}), CUDA-graph replay on {card}: {ms:.4f} ms "
          f"({ms / cfg.n_layers * 1e3:.2f} us per launch); bound "
          f"{max(t_bytes, t_ops):.5f} ms ({step_bytes} bytes: {full} full "
          f"pages x {page_bytes} B of codes and scales per layer + q + "
          f"partials); plain {plain_ms:.4f} ms; issued eagerly {eager:.4f} "
          f"ms; context (the port never calls it): gather the table's "
          f"code pages and scales, dequantize those, then "
          f"scaled_dot_product_attention {lib_ms:.4f} ms; dequantize the "
          f"whole pool, then _paged_gather + scaled_dot_product_attention "
          f"{pool_ms:.4f} ms")
    return dict(launches=launches["paged_attention_quant"], ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib_ms, context_whole_pool_ms=pool_ms,
                eager_ms=eager, max_abs_err=err,
                scope=f"one decode step: {cfg.n_layers} launches, B={b}, "
                      f"{full} full pages, splits {splits}, n_bits "
                      f"{KV_BITS}")


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
