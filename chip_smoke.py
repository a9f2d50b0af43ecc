#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, in order; any failure exits non-zero before the result line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every CUDA kernel from ``src/repro_torch/kernels/*/
   csrc`` with ``nvcc`` (its time and ptxas' register report);
2. K1, the LOG2 quantizer, bit-equal to its plain version on the card: the
   main path's activation shapes in f32 and bf16 plus the special-value
   lattice, n_bits 2..8, one tensor a call; then its list call
   (``log2quant_many``, up to ``MAX_ENTRIES`` tensors of one dtype a
   launch) on ragged lists (entries of 0, 1, 3, 15, 16, 17, 1000 and
   7 x 13 elements and the lattice, each also a view at storage offset
   1..3) in f32, bf16 and f16, a list of the three dtypes, the 210
   activation shapes of a decode step (more than one launch) and the
   inputs above, each launch counted, the flat buffers the views;
3. K2, the LOG2-quantize + plane-skipping bit-plane GEMM in one launch,
   bit-equal to its plain version (``log2_quantize`` of ``x / act_scale``,
   ``unpack_planes``, ``shiftadd_matmul_bitplane``) and, up to 4 bits, to
   the direct-shift oracle on the card: every main-path (K, N), smollm-135m's,
   mamba2-780m's (1536, 3072) and (3072, 1536), deepseek-moe-16b's
   (2048, 2048), (2048, 2816) and (2816, 2048) (22 K-tiles over 8 cluster
   ranks) and qwen3-32b's (5120, 8192), (5120, 1024), (8192, 5120),
   (5120, 25600) and (25600, 5120) (200 K-tiles), with M in
   ``PHASE3_M``, unpacked and packed planes, x in f32 and bf16, act_scale
   in ``PHASE3_SCALES``, n_bits 2..5, both of the kernel's bodies (the
   tensor cores up to 4 bits) and the wrapper's own choice (the oracle,
   whose temporaries are (rows, K, N), on at most 16 rows at qwen3's
   shapes); the projection shapes of qwen2.5-14b, phi4-mini-3.8b,
   internvl2-26b and musicgen-medium (``OTHER_KN``) at M 4 and 128, bf16,
   n_bits 4, both layouts and bodies; the codes it
   writes equal K1's plain version; cold activations, extreme exponents
   and a fully pruned tile; the codes entry (prologue skipped); one
   CUDA-graph capture and replay equal to the eager result;
4. full-width smollm-135m in bf16 (random weights from seed 0), batch 4,
   prompt 64, 32 new tokens through ``greedy_generate``: float, then
   quantized with stats, then quantized with packed planes.  Each
   configuration is one program: its first call captures the CUDA graph,
   the second replays it (the main path), then the same body runs under
   ``engine.eager()``; tokens and stats of the two are equal.  K2 must
   launch 210 x 32 times in each quantized run, by the graph's capture
   census times its replays and counted by the wrapper in the eager run
   (30 layers x 7 projections x (1 prefill + 31 decode forwards)), and
   K1 not at all (it is K2's prologue), packed tokens must equal unpacked
   ones, and on one decode step's real activations the codes K2 wrote
   must equal K1's plain version and its output K2's plain version for
   every projection of every layer.  Then the smoke config in f32 on the
   card against the plain path on the host (tokens equal, logits close);
5. K2's time by CUDA-graph replay of one real decode step's 210 launches
   (M = 4), unpacked and packed planes, each beside its bound (the plane
   bytes of the tiles the skip rule reads, 1/8 of it packed, plus x and the
   output, over 3.35 TB/s), the plain version, K1 then K2 fed its codes
   (two launches), and the bf16 ``torch.matmul`` of the same shapes as
   context; the same kernel fed the step's codes (its prologue skipped)
   and the launch floor (an empty kernel of each launch's grid, block and
   cluster shape); K1 alone on the step's 210 activations, as one list
   call and as one launch per tensor, bit-equal; then us per launch
   of both bodies at 64 and 128 rows (chunk) and 256 rows (the prefill's
   real activations) per (K, N), beside the bytes and bf16 tensor-core
   bounds, the codes-fed time and the launch floor.  With ``--parent DIR``
   (a checkout of an earlier tree, e.g. ``git archive`` of the parent
   commit), the same inputs also go through that tree's K1 then K2, held
   equal to this tree's output and timed at every one of these shapes.
   Then the same for mamba2-780m (phase 10's model): one decode step's 144
   launches (M = 4; its codes and outputs held against K1's and K2's
   plain versions on every projection) beside their bound, and us per
   launch of both bodies at M 4, 8, 16, 64, 128 and 256 (the prefill's
   real activations) at (1536, 3072) and (3072, 1536), with which body
   the wrapper's tensor-core switch takes and whether it is the faster;
6. K3, the paged-attention decode, against its plain version on the card:
   page_len {1, 4, 8} x (G, R) {(1,1), (2,2), (1,3)} x D {8, 16} plus
   smollm-135m's (3, 3, 64) at page_len 16, and the serving path's
   geometry (page_len 16, 32 table columns, lengths 512..0, so that every
   warp of a block walks several pages) at (G, R, D) (3, 3, 64), (3, 3,
   128), (1, 8, 64), deepseek-moe-16b's (16, 1, 128), jamba-v0.1-52b's
   (8, 4, 128), qwen3-32b's (8, 8, 128) (the walk's whole row tile),
   qwen2.5-14b's (8, 5, 128), phi4-mini's (8, 3, 128), internvl2-26b's
   (8, 6, 128) and musicgen-medium's (24, 1, 64), splits 1..4, f32 and
   bf16, at the reference's
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
   tokens each.  In f32, at the first 4 of the 30 layers (to keep the
   script's time), the gather read and K3 give equal tokens for every
   request, float and quantized (these audited runs synchronise
   with the host, so they run under ``engine.eager()``).  In bf16, K3
   float and K3 quantized with stats (the slice's main path) each run as
   CUDA-graph programs over all 30 layers, then at the first
   ``CUT_LAYERS`` (4) layers as graphs and under ``engine.eager()`` (an
   eager run at 30 layers takes 24-97 s), every count set to 0 just
   before each run and read just after: the two cut runs are held equal
   in tokens, per-request stats, forwards and every tick's page table;
   each run reports whole-trace and decode-only tok/s and ms per decode
   step, the full graph run ``compile_stats()`` (tick 1, chunk and
   mixed at most 1, prefill at most 4), each graph's capture ms, replays,
   launch census and kernel-node count, and its tick graph's device time
   replayed alone; launches (by census x replays in the graph runs, by
   the wrappers' counts in the eager run: K3 = layers x decode forwards;
   K2 = 7 x layers x forwards, K1 0), prefix-cache stats and traffic
   fractions.  The first tick that can only decode is traced with
   ``torch.profiler`` in the full quantized graph run: its device-busy
   share and top five device ops.  On the tick that touches most
   pages, K3 against its plain version for all 30 layers (real pool,
   tables and lengths, random queries), then its time by CUDA-graph
   replay of the step's 30 launches beside its bound (touched K/V
   pages, q and the partials over 3.35 TB/s), the plain version's time
   and, as context,
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
   first 4 of the 30 layers (to keep the script's time), the
   quantized-gather read and K4: every K4 call within f32 tolerance of
   the dequantize-and-gather math on the same inputs, and tokens equal
   unless the two runs wrote a different K/V code (these audited runs
   go through ``engine.eager()``).  In bf16 with ``quant=True`` on
   packed planes, the deploy format (the slice's main path: K2, with K1
   in its prologue, and K4 on every decode step), as CUDA-graph
   programs over all 30 layers, then at the first ``CUT_LAYERS`` (4)
   layers as graphs and under ``engine.eager()`` (88 s at 30 layers),
   the two cut runs held equal in tokens, forwards, every tick's page
   table and a digest of the code and scale pages after every tick;
   tok/s, decode-only tok/s, ms per decode step,
   ``compile_stats()`` and each graph's capture, launches (as phase 7),
   hit rate, the pool bytes per request of the reference bench's byte
   model; on the tick that touches most pages, K4 against its plain
   version for all 30 layers (rows of up to 372 tokens: the partial o
   held divided by its split's l), then its time by CUDA-graph replay of
   the step's 30 launches beside its bound (the full code pages it
   reads, their scales, q and the partials over 3.35 TB/s), the plain
   version's time and two contexts: gathering the table's code pages and
   scales, dequantizing only those, then
   ``F.scaled_dot_product_attention`` (``library_ms``), and dequantizing
   the whole pool, then ``_paged_gather`` + the same SDPA;
10. full-width mamba2-780m (48 layers, d 1536, 48 SSD heads x 64, state
   128; random weights from seed 0) in bf16.  One-shot through
   ``greedy_generate`` at batch 4, prompt 64, 32 new tokens: float, then
   quantized with stats, then on packed planes, each as a graph and under
   ``engine.eager()``, held equal in tokens and stats; K2 launches 144 x
   32 (48 layers x wz, wx, out_proj x 32 forwards) by census x replays
   and by the wrappers' count, K1, K3 and K4 none; one decode step as its
   own program: its graph nodes, replayed device ms and eager ms.  The
   bytes one decode step moves, split into projection weights or planes
   and SSM/conv state (from the model's shapes).  Then phase 7's trace and
   ``ServeConfig`` through ``ServeScheduler``, quantized on packed planes
   with stats, as graphs: tok/s, ms per decode step (host clock, and the
   tick graph replayed alone), graph nodes per step, ``compile_stats()``,
   hit rate and snapshots taken; then the model's first ``CUT_LAYERS``
   (4) layers over the same trace as graphs and under ``engine.eager()``,
   held equal in tokens, stats, forwards, snapshots and every tick's page
   table (an eager run at 48 layers takes minutes).
   Last, three requests sharing a 64-token prefix (``chunked="always"``,
   ``chunk_len == page_len == 16``, the first served before the other
   two are submitted): 2 hits through SSM snapshots, tokens equal to the
   same requests served without the prefix cache.
11. full-width deepseek-moe-16b (28 layers ``attn_moe``, d 2048, 16 MHA
   heads x 128, 64 routed experts top-6 with ffe 1408, 2 shared experts,
   vocab 102400, untied; random weights from seed 0) in bf16.  One-shot
   as phase 10, float and quantized on packed planes with stats: K2
   launches 196 x 32 (28 layers x wq, wk, wv, wo and the shared experts'
   gate, up, down); one decode step as its own program; the bytes a
   decode step moves, split into routed experts (all 64 read every
   forward by the reference's local formulation), planes, lm head, the
   rest and the KV, beside the measured step; on one decode step's real
   activations every K2 call's codes and output held against K1's and
   K2's plain versions, its time on both plane layouts beside its bound,
   and the routed-expert products of the step beside their byte bound.
   Then phase 7's trace and ``ServeConfig`` with K3, packed planes with
   stats, as graphs at the first ``SCHED_LAYERS`` (14) layers: tok/s, ms
   per decode step (host, device), nodes per step, ``compile_stats()``;
   the first ``CUT_LAYERS`` (4) layers over the
   same trace as graphs and under ``engine.eager()``, held equal, and
   the routed slots each tick of that eager run dropped over capacity,
   and K3 on the tick that touches most pages at (16, 1, 128) as phase 7
   times it.  Then jamba-v0.1-52b at published width cut to one 8-layer
   period (4 ``mamba_moe`` layers of 16 experts top-2, ffe 14336):
   one-shot float and packed, graph against eager, and one decode step's
   37 K2 calls held against the plain versions.  Last, the deepseek-moe,
   jamba and phi3.5-moe smoke configs in f32 on the card against the
   plain path on the host (as phase 4 ends).
12. full-width qwen3-32b (64 layers, d 5120, 64/8 heads x 128 with
   ``qk_norm``, ff 25600, vocab 151936, untied; random weights from seed
   0) in bf16: ``torch.cuda.max_memory_allocated`` after the init, across
   the float runs and across the quantization.  One-shot float (graph and
   eager equal) and one decode step as its own program, and the bf16
   ``torch.matmul`` of a step's 448 projections as context; then every
   program that holds the float weights is dropped and the model is
   quantized in place on packed planes with ``drop_float=True`` (each
   float leaf freed as its planes exist: 34.3 GB resident after it).
   One-shot packed with stats, graph and eager equal, K2 launching 448 x
   32 by census x replays and by the wrappers (K1, K3, K4 none); one
   packed decode step as its own program beside the bytes bounds of a
   float and a packed step (from the shapes); all 448 K2 calls of one
   decode step held against K1's and K2's plain versions on their real
   activations, then timed by CUDA-graph replay beside their bound and
   the plain version.  Then phase 7's trace and ``ServeConfig`` with K3,
   packed planes with stats, as graphs at the first ``SCHED_LAYERS`` (16)
   layers (tok/s, ms per decode step, nodes, ``compile_stats()``, K3 on
   the tick touching most pages at (8, 8, 128) as phase 7 times it, 64
   launches over the pool's 16 layers), and the model's first ``CUT_LAYERS`` (4)
   layers over the same trace as graphs and under ``engine.eager()``,
   held equal (the eager run of the whole trace at 64 layers would take
   minutes).  Last, the qwen3, qwen2.5 and
   phi4-mini smoke configs as phase 4 ends, internvl2 through the
   prefill step and the decode loop and musicgen frame by frame, each in
   f32 on the card against the host (quantized: every K2 call equal up
   to the first input that crosses a LOG2 code boundary by float
   rounding alone).

13. the paper's own evaluation at the published sizes, in f32: AlexNet
   (227x227, batch 1), PTBLM (2 LSTM layers, hidden 1500, seq 35), the
   transformer (6 + 6 blocks, d 512, ff 2048, ReLU), BERT-base (12 x 768
   x 3072) and BERT-large (24 x 1024 x 4096), GELU, seq 128, weights from
   a seeded generator on the card.  Each forward timed (CUDA events, and
   its graph replayed) with its peak memory; the forward, then K1 on
   all the net's recorded GEMM inputs (8, 3, 48, 48 and 96) in one list
   call: one launch a net, 5 in all (every other kernel none), the codes
   bit-equal to the plain version and to one launch per tensor (the
   earlier calling convention, outside the counted run); K1's time by
   graph replay beside its bytes bound, one launch per tensor's and the
   plain version's on the same tensors; ``measure`` over the flat codes,
   equal to ``measure`` over the per-tensor codes concatenated, and
   ``weight_access_report`` per layer; the same weights through the
   plain path on the host, the share of codes that differ held under
   ``FLIP_LIMIT`` (1e-4) per net; then the simulator on the five
   workloads and three accelerators, with the card's statistics and with
   ``paper_preset``: Fig. 2's negative-exponent shares, Fig. 3's mean
   savings and the averages of Figs. 9-11 against NaHiD and Neurocube,
   each beside the paper's value.

14. disaggregated serving (``serving/workers.py``, ``serving/router.py``):
   prefill and decode engines, each its own ``ServeScheduler`` with its
   own graphs, passing PageSpans.  Through the in-process
   ``Router``, phase 7's trace and ``ServeConfig``: smollm-135m full width
   in bf16 float with K3 (phase 7's graph run) and on packed planes with
   ``kv_quant=True, kv_bits=4``, K2 and K4 (phase 9's); then
   mamba2-780m, phase 10's configuration, over the first
   ``MAMBA_ROUTED`` (8) requests of its trace.  Tokens, finish reasons
   and errors equal those combined runs; launches by census x replays
   over both engines' programs (K3 or K4 = layers x the decode engine's
   forwards, K2 = projections x layers x both engines' forwards); the
   decode fleet's tick p50/p95 beside the combined run's ticks with and
   without a chunk (host clock around ``step_tick``), each span's bytes,
   export and import ms, and one frame written, read and written again
   to the same bytes.  Then ``run_disaggregated``: smollm-135m full width
   across two spawned processes on the card, 8 requests (one over
   ``max_len``, rejected), equal to the combined scheduler in this
   process; the decode worker's tick ms and the bytes per frame.

15. training (``train/trainer.py``, ``optim/adamw.py``, the flash
   Function of ``models/attention.py``, ``checkpoint/manager.py``,
   ``launch/train.py``), with no kernel of the serving paths (their counts
   stay 0).  All ten smoke configs in f32: one step's loss and gradients
   on the card against the plain host run on the same weights and batch
   (gradients within ``TRAIN_SMOKE_REL`` of each leaf's largest
   magnitude).  The flash Function against torch autograd through the
   plain chunked forward at smollm-135m's attention (B 8, S 1024, 9/3
   heads x 64), ``kv_chunk`` 1024 and 256, f32 (within
   ``FLASH_F32_REL``) and bf16 (as close to the f32 gradients as plain
   autograd's bf16 ones, twice or 2^-7), no saved tensor of a chunk's
   score shape (``saved_tensors_hooks``), and the device time of a
   forward plus backward of each.  Full-width smollm-135m in bf16 from
   seed 0 through ``train_loop``: ``TRAIN``'s 20 steps of global batch
   16 x 1024 tokens in 2 micro-batches, AdamW lr 3e-4, warmup 5; every
   loss and grad norm finite, the last loss at least 0.5 nats below the
   first; the state saved with ``save_async`` at step 10, restored by a
   fresh manager into a fresh tree and trained over steps 10-19 again,
   losses and final state bit-equal; the step's host and device time
   (with deterministic kernels and without), tokens/s, peak memory,
   FLOPs a step and their share of the dense bf16 peak, one profiled
   step (the top five device ops, the flash forward and backward's
   share), save and restore seconds.  Last, ``repro_torch.launch.train``
   at full width in two child processes: 4 steps with a checkpoint every
   2, then ``--steps 6 --resume auto``, which resumes at step 4.

Prints a ``serving:`` line (graph and eager tok/s of phases 4, 7, 9, 10,
11 and 12), a ``paper evaluation:`` line (phase 13's nets and figures), a
``disaggregated:`` line (phase 14), a ``training:`` line (phase 15), a
``kernels:`` line, the JSON kernel table and, last, the result line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX and nothing
of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
INT32_OPS_PER_S = 67e12             # CUDA-core 32-bit rate (f32 figure)
BF16_FLOPS_PER_S = 989e12           # dense bf16 tensor cores
PHASE3_M = [1, 4, 8, 16, 17, 63, 64, 128, 256]
PHASE3_SCALES = [1.0, 0.37, 2.0 ** -3]
MAIN_KN = [(576, 576), (576, 192), (576, 1536), (1536, 576),
           (1536, 3072), (3072, 1536),      # smollm-135m, mamba2-780m
           (2048, 2048), (2048, 2816), (2816, 2048),    # deepseek-moe-16b
           (5120, 8192), (5120, 1024), (8192, 5120),    # qwen3-32b
           (5120, 25600), (25600, 5120)]
# the other dense configurations' projection shapes, held at M 4 and 128,
# bf16, n_bits 4: qwen2.5-14b, phi4-mini-3.8b, internvl2-26b,
# musicgen-medium
OTHER_KN = [(5120, 5120), (5120, 13824), (13824, 5120),
            (3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072),
            (6144, 6144), (6144, 1024), (6144, 16384), (16384, 6144),
            (1536, 1536), (1536, 6144), (6144, 1536)]
# the direct-shift oracle builds (rows, K, N) int32 temporaries: above
# this many weights it runs on the cases of at most 16 rows
ORACLE_MAX_KN = 1 << 24
BATCH, PROMPT, NEW = 4, 64, 32
PROJ = ["wq", "wk", "wv", "wo", "gate", "up", "down"]
MAMBA_PROJ = ["wz", "wx", "out_proj"]
MAMBA_M = [4, 8, 16, 64, 128, 256]   # phase 5's rows at the mamba shapes
F32_TOL = (2e-5, 2e-6)              # rtol, atol (tests/test_paged_attention)
BF16_TOL = (0.0, 2e-2)
SERVE = dict(max_slots=8, max_len=512, buckets=(16, 32, 64, 128),
             tick_steps=8, chunked="auto", paged=True, page_len=16,
             prefix_cache=True, attn_splits=2)
SERVE_NEW = 32
KV_BITS = 4
F32_LAYERS = 4                      # depth of phases 7 and 9's f32 runs
CUT_LAYERS = 4                      # depth of phases 7, 9-12 eager runs
# depth of phases 11 and 12's whole-trace scheduler runs (graphs), cut
# from 28 and 64 layers to keep the script inside its time limit with
# phase 15; the one-shot runs and decode-step programs keep full depth
SCHED_LAYERS = {"deepseek-moe-16b": 14, "qwen3-32b": 16}
# phases 6 and 8 at the serving path's geometry (page_len 16, 32 table
# columns): rows long enough that every warp of a block walks several
# pages, at smollm-135m's (G, R, D), at D = 128 and R = 8, at
# deepseek-moe-16b's and jamba-v0.1-52b's, and at qwen3-32b's (8, 8, 128),
# qwen2.5-14b's (8, 5, 128), phi4-mini's (8, 3, 128), internvl2-26b's
# (8, 6, 128) and musicgen-medium's (24, 1, 64)
LONG_LENGTHS = [512, 300, 64, 33, 17, 16, 1, 0]
LONG_GEOS = [(3, 3, 64), (3, 3, 128), (1, 8, 64), (16, 1, 128), (8, 4, 128),
             (8, 8, 128), (8, 5, 128), (8, 3, 128), (8, 6, 128), (24, 1, 64)]
# phase 13: the paper's five nets (Table I), K1's launches on each (one list
# call of its 8, 3, 48, 48 or 96 recorded GEMM inputs), the bound on codes
# that may differ between the card and the host, and the paper's printed
# values (the constants of benchmarks/paper_figures.py, copied)
PAPER_NETS = ["alexnet", "ptblm", "transformer", "bert-base", "bert-large"]
PAPER_K1_LAUNCHES = {"alexnet": 1, "ptblm": 1, "transformer": 1,
                     "bert-base": 1, "bert-large": 1}
FLIP_LIMIT = 1e-4
# phase 14: mamba2-780m's routed requests (the first of phase 10's trace)
MAMBA_ROUTED = 8
# K1's list call and its per-tensor yardstick are timed with this many
# calls captured in one graph (a replay's start, a few us, would otherwise
# weigh on the small nets' single launch)
K1_INNER = 10
PAPER_VALUES = {
    "neg_frac": {"alexnet": 0.36, "ptblm": 0.98, "transformer": 0.57,
                 "bert-base": 0.82, "bert-large": 0.85},
    "fig3_avg_savings": 0.25,
    "fig9_avg_vs_neurocube": 0.276,
    "fig9_avg_vs_nahid": 0.75,
    "fig10_avg_vs_neurocube": 4.25,
    "fig10_avg_vs_nahid": 1.38,
    "fig10_ptblm_vs_nahid": 1.86,
    "fig10_alexnet_vs_nahid": 1.07,
    "fig11_avg_vs_neurocube": 3.52,
    "fig11_avg_vs_nahid": 1.28,
    "fig11_ptblm_vs_neurocube": 8.2,
    "fig11_ptblm_vs_nahid": 1.6,
}


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


def k1_lists(torch, dev, g, lat):
    """Phase 2's lists for K1's list call: ``(label, tensors)``.  The
    lattice cut into entries of 0, 1, 3, 15, 16, 17, 1000 and 7 x 13
    elements plus the whole lattice, in f32, bf16 and f16, with each entry
    a contiguous view at storage offset 0 (aligned) to 3 (a pointer off
    16 bytes); a list of the three dtypes; the 210 activation shapes of a
    smollm-135m decode step (more entries than one launch takes)."""
    out = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = lat.to(dtype)
        for shift in range(4):
            xs, o = [], 0
            for shape in [(0,), (1,), (3,), (15,), (16,), (17,), (1000,),
                          (7, 13)]:
                n = math.prod(shape)
                base = torch.cat([x, x])[o:o + n + shift].clone()
                xs.append(base[shift:].view(shape))
                o += n
            out.append((f"ragged {str(dtype)[6:]} offset {shift}",
                        xs + [x]))
    out.append(("mixed dtypes", [lat[:700].to(dt) for dt in (
        torch.float32, torch.bfloat16, torch.float16)] * 2 + [lat[1:]]))
    step = [torch.randn((BATCH, 1536 if i % len(PROJ) == len(PROJ) - 1
                         else 576), generator=g, device=dev)
            for i in range(30 * len(PROJ))]
    out.append(("decode-step shapes", step))
    return out


def sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def graph_ms(torch, fn, reps: int = 20, inner: int = 1) -> float:
    """Device time of ``fn``'s work, by CUDA-graph replay (no host launch
    overhead), averaged over ``reps`` replays; with ``inner`` > 1 the graph
    holds ``inner`` calls of ``fn`` and the time is per call (a replay's
    own start, a few us, spread over them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
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
    return start.elapsed_time(end) / reps / inner


def eager_ms(torch, fn, reps: int = 5, warm: bool = True) -> float:
    """Time of ``fn`` issued from the host as the eager path issues it
    (after one unmeasured call unless ``warm`` is False)."""
    if warm:
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of an earlier tree of this repository: "
                         "phase 5 also times its K1 + K2 sequence on the "
                         "same inputs")
    args = ap.parse_args()
    if not (REPO / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO / "src"))
    # cuBLAS picks its reduction order per workspace: a fixed workspace
    # config keeps the graph runs bit-equal to their engine.eager() runs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    t_main = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.core.logquant import LogQuantized, log2_quantize
    from repro_torch.core.shiftadd import QuantCtx, shiftadd_matmul_bitplane
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitplane_matmul import ops as bm_ops
    from repro_torch.kernels.log2quant import ops as l2_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models.model import init_caches, init_params
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
    # the list call: ragged lists, misaligned views, a list of three
    # dtypes, the decode step's 210 activation shapes (more than one
    # launch) and the main-path inputs above, each launch counted
    lists = k1_lists(torch, dev, g, lat) + [("main-path inputs", inputs)]
    for label, xs in lists:
        for n_bits in range(2, 9):
            before = l2_ops.log2quant.launches
            flat, views = l2_ops.log2quant_many(xs, n_bits)
            torch.cuda.synchronize()
            launched = l2_ops.log2quant.launches - before
            check(launched == len(l2_ops.launch_plan(xs)),
                  f"K1 list {label}: {launched} launches")
            for i, (x, v) in enumerate(zip(xs, views)):
                ref = log2_quantize(x, n_bits)
                check(v.exp.shape == x.shape and torch.equal(v.exp, ref.exp)
                      and torch.equal(v.sign, ref.sign),
                      f"K1 list {label} entry {i} {tuple(x.shape)} "
                      f"{x.dtype} n_bits={n_bits} differs from the plain "
                      f"version")
                if x.numel():
                    k1_err = max(k1_err, int((v.exp.int() - ref.exp.int())
                                             .abs().max()))
            check(torch.equal(flat.exp, torch.cat(
                [v.exp.reshape(-1) for v in views])) and torch.equal(
                flat.sign, torch.cat([v.sign.reshape(-1) for v in views])),
                f"K1 list {label}: the flat buffers are not the views")
            k1_checked += 1
        print(f"  K1 list {label}: {len(xs)} entries, "
              f"{sum(x.numel() for x in xs)} elements, "
              f"{len(l2_ops.launch_plan(xs))} launch(es), n_bits 2..8")
    torch.cuda.synchronize()
    print(f"phase 2: K1 bit-equal to its plain version in {k1_checked} "
          f"cases (f32/bf16/f16, n_bits 2..8, lattice + main-path shapes; "
          f"one tensor a call, then lists of up to "
          f"{l2_ops.MAX_ENTRIES} entries a launch)")

    # -- phase 3: K2 against its plain version and the oracle ---------------
    k2_err = phase3(torch, dev, g, bm_ops)

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

    # each configuration is one program: its first call captures the
    # graph (timed as the capture), the second replays it (the main path:
    # its launches are the capture census times the replays), then the
    # same body runs under engine.eager(); the two runs are held equal
    qparams = quantize_model_params(cfg, params)
    pparams = quantize_model_params(cfg, params, pack=True)
    gen_runs = {}
    for tag, p, quant, stats in (("float", params, False, False),
                                 ("quant+stats", qparams, True, True),
                                 ("packed", pparams, True, False)):
        def call(p=p, quant=quant, stats=stats):
            return engine.greedy_generate(cfg, p, prompt, NEW, quant=quant,
                                          with_stats=stats)
        _, t_cap = sync_time(torch, call)
        prog = engine.generate_fn(cfg, p, NEW, 0.0, quant, None, stats,
                                  dev).program
        (entry,) = prog.entries()
        before = entry.replays
        l2_ops.log2quant.launches = bm_ops.bitplane_matmul.launches = 0
        out, t_graph = sync_time(torch, call)
        replayed = {k: n * (entry.replays - before)
                    for k, n in entry.census.items()}
        check(l2_ops.log2quant.launches == bm_ops.bitplane_matmul.launches
              == 0, f"{tag}: a kernel ran outside the graph replay")
        with engine.eager():
            eager_out, t_eager = sync_time(torch, call)
        eager_launches = {"log2quant": l2_ops.log2quant.launches,
                          "bitplane_matmul": bm_ops.bitplane_matmul.launches}
        toks, st = out if stats else (out, None)
        etoks, est = eager_out if stats else (eager_out, None)
        check(torch.equal(toks, etoks) and (not stats or all(
            torch.equal(st[k], est[k]) for k in st)),
            f"{tag}: graph tokens or stats differ from engine.eager()'s")
        nodes = engine.graph_nodes(entry)
        gen_runs[tag] = dict(toks=toks, stats=st, t_cap=t_cap,
                             t_graph=t_graph, t_eager=t_eager,
                             replayed=replayed, eager=eager_launches,
                             capture_ms=entry.capture_ms, nodes=nodes)

    # every quantized projection is one launch of the fused K2, which
    # quantizes in its prologue: K1 is not launched on the main path
    want = {"log2quant": 0, "bitplane_matmul": per_run}
    for tag in ("quant+stats", "packed"):
        for label in ("replayed", "eager"):
            got = gen_runs[tag][label]
            for kname in want:
                check(got[kname] == want[kname], f"{tag} {label}: {kname} "
                      f"launched {got[kname]} times, expected {want[kname]}")
    check(gen_runs["float"]["replayed"]["bitplane_matmul"] == 0
          and gen_runs["float"]["eager"]["bitplane_matmul"] == 0,
          "the float path launched a quantized kernel")
    launches = {k: gen_runs["quant+stats"]["replayed"][k] for k in want}
    toks_f, toks_q = gen_runs["float"]["toks"], gen_runs["quant+stats"]["toks"]
    stats = gen_runs["quant+stats"]["stats"]
    check(torch.equal(gen_runs["packed"]["toks"], toks_q),
          "packed-plane tokens differ from unpacked")
    for toks in (toks_f, toks_q):
        check(toks.shape == (BATCH, NEW) and bool((toks >= 0).all())
              and bool((toks < cfg.vocab_size).all()), "bad token tensor")
    tile = stats["plane_traffic_fraction"].cpu()
    elem = stats["element_traffic_fraction"].cpu()
    check(bool((tile[:-1] > 0).all() and (tile[:-1] <= 1).all()
               and (elem[:-1] > 0).all() and (elem <= tile + 1e-6).all()
               and tile[-1] == 0), f"bad traffic stats {tile} {elem}")
    new = BATCH * NEW
    for tag, r in gen_runs.items():
        nodes = r["nodes"]
        print(f"  {tag}: {new} tokens, graph replay {r['t_graph']:.4f} s = "
              f"{new / r['t_graph']:.1f} tok/s; engine.eager() "
              f"{r['t_eager']:.4f} s = {new / r['t_eager']:.1f} tok/s; first "
              f"call (warm-up + capture + replay) {r['t_cap']:.3f} s, capture "
              f"{r['capture_ms']:.1f} ms; graph kernel nodes "
              + (f"{nodes[0]} of {nodes[1]}" if nodes else "not available")
              + f"; tokens and stats equal to engine.eager()'s")
    print(f"  launches per quantized run: replayed {launches}, "
          f"engine.eager() {gen_runs['quant+stats']['eager']} "
          f"(K2 = {cfg.n_layers} layers x {len(PROJ)} projections x {NEW} "
          f"forwards; K1 folded into K2's prologue)")
    print(f"  plane traffic per decode step: tile "
          f"{float(tile[:-1].mean()):.6f}, element "
          f"{float(elem[:-1].mean()):.6f}")
    print(f"  quant tokens equal to float tokens: "
          f"{float((toks_q == toks_f).float().mean()):.4f} "
          f"(informational: 4-bit LOG2 activations change tokens)")
    print(f"  packed tokens equal unpacked: True")

    # one decode step's real activations, captured through QuantCtx; the
    # fused op's own inputs of the prefill and of the step recorded
    caches = init_caches(cfg, BATCH, PROMPT + 1, device=dev)
    prefill_calls = recorded(bm_ops, lambda: engine.make_prefill_step(
        cfg, True)(qparams, {"tokens": prompt}, caches))
    logits, caches = prefill_calls.result
    ctx = QuantCtx(capture=[])
    step_calls = recorded(bm_ops, lambda: engine.make_serve_step(cfg, ctx)(
        qparams, caches, torch.argmax(logits, -1).to(torch.int32)[:, None]))
    step_logits, _ = step_calls.result
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
    print(f"  decode step: the fused K2's codes bit-equal to K1's plain "
          f"version and its output to K2's on all {len(ctx.capture)} "
          f"projections' real activations")

    # the smoke config in f32: kernels on the card vs plain path on host
    smoke_on_card(torch, dev, "smollm-135m")

    # -- phase 5: kernel times at the decode, chunk and prefill shapes -----
    t = phase5(torch, dev, g, card, cfg, params, ctx.capture, step_calls,
               prefill_calls, l2_ops, bm_ops, args.parent)
    # phase 4's models and records are not read again (phase 12 needs
    # the card's memory)
    del params, qparams, pparams, p, call, prog, entry, caches, logits
    del step_logits, ctx, step_calls, prefill_calls, xs, exp, sign, planes, y
    gc_cuda(torch)
    # the same for K2 at mamba2-780m's shapes, on phase 10's model
    mamba = mamba_model(torch, dev, bm_ops)
    t_mamba = phase5_mamba(torch, dev, card, mamba, bm_ops)

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

    # -- phase 10: full-width mamba2-780m, one-shot and scheduler ----------
    m10 = phase10(torch, dev, card, mamba, l2_ops, bm_ops, pa_ops)
    print(f"  (phase 10 done at {time.perf_counter() - t_main:.0f} s)")
    del mamba
    gc_cuda(torch)

    # -- phase 11: full-width deepseek-moe-16b, one jamba period ----------
    m11 = phase11(torch, dev, card, l2_ops, bm_ops, pa_ops)
    print(f"  (phase 11 done at {time.perf_counter() - t_main:.0f} s)")

    # -- phase 12: full-width qwen3-32b, float then packed planes alone ----
    m12 = phase12(torch, dev, card, l2_ops, bm_ops, pa_ops)
    print(f"  (phase 12 done at {time.perf_counter() - t_main:.0f} s)")

    # -- phase 13: the paper's evaluation at published sizes ---------------
    m13 = phase13(torch, dev, card, l2_ops, bm_ops, pa_ops)
    print(f"  (phase 13 done at {time.perf_counter() - t_main:.0f} s)")

    # -- phase 14: disaggregated serving, in process and across two -------
    m14 = phase14(torch, dev, card, l2_ops, bm_ops, pa_ops, {
        "float": k3["combined"], "kv_quant": k4["combined"],
        "mamba": m10["combined"]})
    print(f"  (phase 14 done at {time.perf_counter() - t_main:.0f} s)")
    print(f"disaggregated ({card}): {json.dumps(m14)}")
    gc_cuda(torch)

    # -- phase 15: training -------------------------------------------------
    m15 = phase15(torch, dev, card, l2_ops, bm_ops, pa_ops)
    print(f"  (phase 15 done at {time.perf_counter() - t_main:.0f} s)")
    print(f"training ({card}): {json.dumps(m15)}")
    serving = {"phase4": {tag: {
        "graph_tok_s": BATCH * NEW / r["t_graph"],
        "eager_tok_s": BATCH * NEW / r["t_eager"],
        "capture_ms": r["capture_ms"]} for tag, r in gen_runs.items()},
        "phase7": k3["serve"], "phase9": k4["serve"],
        "phase10": m10["serve"], "phase11": m11["serve"],
        "phase11_jamba": m11["jamba"], "phase12": m12["serve"]}
    print(f"serving ({card}): {json.dumps(serving)}")

    table = []
    for kname, src, replaces, err in (
            ("log2quant", "src/repro_torch/kernels/log2quant/csrc/"
             "log2quant.cu", "src/repro/kernels/log2quant/kernel.py:65",
             k1_err),
            ("bitplane_matmul", "src/repro_torch/kernels/bitplane_matmul/"
             "csrc/bitplane_matmul.cu",
             "src/repro/kernels/bitplane_matmul/kernel.py:136", k2_err)):
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[kname],
                 "max_abs_err": err, **t[kname]}
        if kname == "bitplane_matmul":
            # the mamba path: launches of phase 10's quantized one-shot run
            # (census x replays), times at its decode step (phase 5)
            entry["mamba2_780m"] = {"launches": m10["launches"], **t_mamba}
            # the MoE path: launches of phase 11's quantized one-shot run,
            # times at its decode step
            entry["deepseek_moe_16b"] = {"launches": m11["k2_launches"],
                                         **m11["k2"]}
            # the dense path at full width: qwen3-32b on packed planes
            # alone (phase 12)
            entry["qwen3_32b"] = {"launches": m12["k2_launches"],
                                  **m12["k2"]}
        else:
            # the paper evaluation: K1 alone on every recorded GEMM input
            # of the five nets (phase 13)
            entry["paper_nets"] = m13["k1"]
        table.append(entry)
    table.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:219",
        "launches": k3["launches"], "max_abs_err": k3_err, "ms": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
        "scope": k3["scope"], "eager_ms": k3["eager_ms"],
        "deepseek_moe_16b": {"launches": m11["k3_launches"], **m11["k3"]},
        "qwen3_32b": {"launches": m12["k3_launches"], **m12["k3"]}})
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


def smoke_on_card(torch, dev, name: str) -> None:
    """The smoke config of ``name`` in f32 (weights from seed 5, quantized
    on unpacked planes): ``greedy_generate`` float and quantized on the
    card equal to the plain path on the host in tokens, ``forward``
    logits within 1e-4."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import forward, init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

    scfg = get_smoke(name).replace(dtype=torch.float32)
    sp_cpu = init_params(scfg, generator=torch.Generator().manual_seed(5),
                         device="cpu")
    sq_cpu = quantize_model_params(scfg, sp_cpu)
    sq_gpu = _to(torch, sq_cpu, dev)
    sprompt = torch.randint(0, scfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(6),
                            dtype=torch.int32)
    for quant in (False, True):
        a = engine.greedy_generate(scfg, sq_cpu, sprompt, 8, quant=quant,
                                   device="cpu")
        b = engine.greedy_generate(scfg, sq_gpu, sprompt, 8, quant=quant)
        check(torch.equal(a, b.cpu()), f"{scfg.name} tokens (quant={quant}) "
              f"on the card differ from the host's plain path")
        la, _ = forward(scfg, sq_cpu, tokens=sprompt, quant=quant)
        lb, _ = forward(scfg, sq_gpu, tokens=sprompt.to(dev), quant=quant)
        err = float((la - lb.cpu()).abs().max())
        check(err <= 1e-4, f"{scfg.name} logits (quant={quant}) differ by "
              f"{err}")
        print(f"  {scfg.name} f32 (quant={quant}): tokens equal the host's "
              f"plain path, logits max |diff| {err:.2e}")


class _Calls(list):
    result = None


def recorded(bm_ops, fn) -> _Calls:
    """Run ``fn`` with every ``log2_bitplane_matmul`` call's inputs
    recorded; the list's ``result`` is ``fn``'s."""
    calls = _Calls()
    inner = bm_ops.log2_bitplane_matmul

    def record(x, act_scale, planes, n_bits=4, **kw):
        calls.append((x.clone(), act_scale, planes, n_bits))
        return inner(x, act_scale, planes, n_bits, **kw)

    bm_ops.log2_bitplane_matmul = record
    try:
        calls.result = fn()
    finally:
        bm_ops.log2_bitplane_matmul = inner
    return calls


def phase3(torch, dev, g, bm_ops) -> int:
    """K2: the fused op against its plain version, bitplane_matmul_ref and
    K1's plain version; the codes entry on the extreme cases; one graph
    replay.  Returns the max |diff| (0 or the script has failed)."""
    from repro_torch.core.bitplane import pack_planes, to_bitplanes
    from repro_torch.core.logquant import log2_quantize
    from repro_torch.core.shiftadd import shiftadd_matmul_bitplane
    from repro_torch.core.wquant import quantize_weights
    from repro_torch.kernels.bitplane_matmul.ref import bitplane_matmul_ref

    t0 = time.perf_counter()
    stats = {"cases": 0, "launches": 0, "err": 0}

    def hold(label, y, plain, oracle):
        d = int((y.long() - plain.long()).abs().max()) if y.numel() else 0
        stats["err"] = max(stats["err"], d)
        stats["launches"] += 1
        check(d == 0, f"K2 differs from its plain version ({label}): max "
              f"|diff| {d}")
        check(torch.equal(y, oracle), f"K2 differs from the oracle ({label})")

    def weights(k, n, scale=0.05, ones=False):
        w = (torch.ones((k, n), dtype=torch.int8, device=dev) if ones else
             quantize_weights(torch.randn((k, n), generator=g, device=dev)
                              * scale, channel_axis=-1).q)
        unpacked = to_bitplanes(w)
        return w, {"unpacked": unpacked,
                   "packed": pack_planes(unpacked, axis=0)}

    def fused_case(label, x, act, w, layouts, n_bits):
        """Every layout and body of the fused op on x / act.  The direct
        shift oracle is the plane form's equal only up to n_bits 4: at 5 a
        live exponent below -7 floors a negative weight to -1, which no
        plane reaches (the reference's plane form, the kernel's function,
        gives 0 there)."""
        a = torch.tensor(act, dtype=torch.float32, device=dev)
        q = log2_quantize(x.float() / a, n_bits)
        plain = shiftadd_matmul_bitplane(q, layouts["unpacked"], n_bits)
        m, k = x.shape
        small = k * w.shape[1] <= ORACLE_MAX_KN or m <= 16
        oracle = (bitplane_matmul_ref(q.exp, q.sign, w, n_bits)
                  if n_bits <= 4 and small else plain)
        bodies = (False, True) if n_bits <= 4 else (False,)
        for lay, planes in layouts.items():
            for tc in bodies:
                what = f"{label} {lay} {'tc' if tc else 'int'}"
                y, got = bm_ops.log2_bitplane_matmul(
                    x, a, planes, n_bits, codes=True, tensor_cores=tc)
                hold(what, y, plain, oracle)
                check(torch.equal(got.exp, q.exp)
                      and torch.equal(got.sign, q.sign),
                      f"K2's codes differ from K1's plain version ({what})")
            hold(f"{label} {lay} auto", bm_ops.log2_bitplane_matmul(
                x, a, planes, n_bits), plain, oracle)
        stats["cases"] += 1

    for k, n in MAIN_KN:
        w, layouts = weights(k, n)
        for m in PHASE3_M:
            x32 = torch.randn((m, k), generator=g, device=dev)
            x32[torch.rand((m, k), generator=g, device=dev) < 0.1] = 0.0
            for x in (x32, x32.to(torch.bfloat16)):
                for act in PHASE3_SCALES:
                    for n_bits in (2, 3, 4, 5):
                        fused_case(f"{m}x{k}x{n} {x.dtype} act {act} "
                                   f"n_bits {n_bits}", x, act, w, layouts,
                                   n_bits)
        # cold activations: deep negative exponents skip low planes
        fused_case(f"cold {BATCH}x{k}x{n}", torch.randn(
            (BATCH, k), generator=g, device=dev) * 0.02, 1.0, w, layouts, 4)
        del w, layouts
    for k, n in OTHER_KN:
        w, layouts = weights(k, n)
        for m in (BATCH, 128):
            x = torch.randn((m, k), generator=g, device=dev).to(
                torch.bfloat16)
            fused_case(f"{m}x{k}x{n} bf16", x, 1.0, w, layouts, 4)
        del w, layouts
    x = torch.cat([torch.randn((32, 64), generator=g, device=dev) * 1e-3,
                   torch.randn((32, 64), generator=g, device=dev) * 100.0,
                   torch.zeros((32, 64), device=dev)], dim=1)
    w, layouts = weights(192, 64, scale=0.1)
    fused_case("extreme exponents", x, 1.0, w, layouts, 4)
    w, layouts = weights(128, 128, ones=True)
    fused_case("fully pruned tile", torch.zeros((128, 128), device=dev),
               1.0, w, layouts, 4)
    for tc in (False, True):
        check(not bm_ops.log2_bitplane_matmul(
            torch.zeros((128, 128), device=dev), torch.tensor(1.0, device=dev),
            layouts["packed"], tensor_cores=tc).any(),
            "K2 fully pruned tile is not zero")

    # the codes entry (prologue skipped) on the same kinds of input
    for label, (m, k, n, scale) in {
            "codes entry 4x576x192": (BATCH, 576, 192, 1.0),
            "codes entry 256x1536x576": (256, 1536, 576, 1.0),
            "codes entry cold 4x576x1536": (BATCH, 576, 1536, 0.02),
            "codes entry 96x200x130": (96, 200, 130, 0.5)}.items():
        w, layouts = weights(k, n)
        q = log2_quantize(torch.randn((m, k), generator=g, device=dev)
                          * scale)
        plain = shiftadd_matmul_bitplane(q, layouts["unpacked"])
        oracle = bitplane_matmul_ref(q.exp, q.sign, w)
        for lay, planes in layouts.items():
            if lay == "packed" and k % 8:
                continue
            for tc in (False, True):
                hold(f"{label} {lay}", bm_ops.bitplane_matmul(
                    q.exp, q.sign, planes, tensor_cores=tc), plain, oracle)

    # one CUDA-graph capture and replay against the eager result
    for m, k, n in ((BATCH, 576, 1536), (256, 576, 192)):
        w, layouts = weights(k, n)
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        a = torch.tensor(0.37, device=dev)
        eager = bm_ops.log2_bitplane_matmul(x, a, layouts["packed"])
        out = torch.empty_like(eager)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            bm_ops.log2_bitplane_matmul(x, a, layouts["packed"], out=out)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            bm_ops.log2_bitplane_matmul(x, a, layouts["packed"], out=out)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(out, eager), f"K2 graph replay differs from eager "
              f"at {m}x{k}x{n}")
    torch.cuda.synchronize()
    print(f"phase 3: fused K2 bit-equal to its plain version and the oracle "
          f"in {stats['cases']} cases ({stats['launches']} launches: MAIN_KN"
          f" x M {PHASE3_M} x f32/bf16 x act_scale {PHASE3_SCALES} x "
          f"n_bits 2..5, both layouts, both bodies up to 4 bits, the oracle "
          f"on at most 16 rows above {ORACLE_MAX_KN} weights; OTHER_KN x M "
          f"{[BATCH, 128]} bf16 n_bits 4), its codes "
          f"equal to K1's plain version, the codes entry too, graph replay "
          f"equal to eager ({time.perf_counter() - t0:.1f} s)")
    return stats["err"]


def k2_bound(torch, bm_ops, exp, n, packed, dtype_bytes):
    """(bytes, ops) one launch must move and do: the plane bytes of the
    tiles its skip rule reads (1/8 of it packed), x, the output; the
    plane products of those tiles (2 per weight and plane)."""
    m, k = exp.shape
    table = bm_ops._skip_table(torch.nn.functional.pad(
        exp, (0, (-k) % 128, 0, (-m) % 128), value=-8), 128, 128, 4, 8)
    depth = torch.full((table.shape[1],), 128.0, device=exp.device)
    if k % 128:
        depth[-1] = k % 128
    rows = torch.full((table.shape[0], 1), 128.0, device=exp.device)
    if m % 128:
        rows[-1] = m % 128
    planes = (8 - table).float()
    plane_bytes = float((planes.amax(0) * depth).sum()) * n
    ops = float((planes * depth * rows).sum()) * n * 2
    return (plane_bytes / (8 if packed else 1) + m * k * dtype_bytes
            + m * n * 4), ops


def parent_ops(parent: Path):
    """The K1 and K2 wrappers of another tree of this repository (a
    checkout at ``parent``), built from its own sources: imported while its
    ``src`` leads ``sys.path`` and this tree's ``repro_torch`` modules are
    set aside, which then come back.  The two trees' libraries load side by
    side (ctypes looks a symbol up in its own library)."""
    def ours():
        return [k for k in sys.modules
                if k == "repro_torch" or k.startswith("repro_torch.")]

    mine = {k: sys.modules.pop(k) for k in ours()}
    src = str(Path(parent).resolve() / "src")
    sys.path.insert(0, src)
    try:
        l2 = importlib.import_module("repro_torch.kernels.log2quant.ops")
        bm = importlib.import_module(
            "repro_torch.kernels.bitplane_matmul.ops")
        check(Path(bm.__file__).is_relative_to(src),
              f"--parent {parent}: no repro_torch under it")
        l2._lib()
        bm._lib()
    finally:
        sys.path.remove(src)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)
    return l2, bm


def launch_floor(torch, bm_ops, m, k, n, n_bits, packed, tc):
    """One launch of an empty kernel of the shape (grid, block, cluster)
    that ``log2_bitplane_matmul`` gives this call."""
    rc = bm_ops._lib().qh_bitplane_matmul_launch_floor(
        m, k, n, n_bits, int(packed), int(tc),
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"launch floor {m}x{k}x{n} failed: {rc}")


def k2_decode_step(torch, bm_ops, step_calls, capture):
    """One decode step's recorded K2 calls (``recorded``) and their
    ``QuantCtx`` capture as runnable steps: ``(layouts, run(lay), plain,
    floor(lay), bounds)``, ``layouts`` the step's planes unpacked and
    packed, ``bounds[lay]`` = (ms, "bytes" | "operations")."""
    from repro_torch.core.bitplane import pack_planes

    packed = {id(c[2]): pack_planes(c[2], axis=0) for c in step_calls}
    layouts = {"unpacked": [c[2] for c in step_calls],
               "packed": [packed[id(c[2])] for c in step_calls]}

    def run(lay):
        def go():
            for (x, a, _, nb), planes in zip(step_calls, layouts[lay]):
                bm_ops.log2_bitplane_matmul(x, a, planes, nb)
        return go

    def plain():
        for x, a, planes, nb in step_calls:
            bm_ops.log2_bitplane_matmul_plain(x, a, planes, nb)

    def floor(lay):
        def go():
            for x, _, planes, nb in step_calls:
                m, k = x.shape
                n = planes.shape[2]
                launch_floor(torch, bm_ops, m, k, n, nb, lay == "packed",
                             bm_ops.tensor_core_body(m, n, nb))
        return go

    bounds = {}
    for lay in layouts:
        nbytes = nops = 0.0
        for (x, _, planes, _), (_, exp, *_) in zip(step_calls, capture):
            b, _ = k2_bound(torch, bm_ops, exp, planes.shape[2],
                            lay == "packed", x.element_size())
            nbytes += b
            # the integer body: a multiply-add per (m, k, n)
            nops += 2 * x.shape[0] * x.shape[1] * planes.shape[2]
        by, op = nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S
        bounds[lay] = (max(by, op) * 1e3, "bytes" if by >= op
                       else "operations")
    return layouts, run, plain, floor, bounds


def phase5(torch, dev, g, card, cfg, params, capture, step_calls,
           prefill_calls, l2_ops, bm_ops, parent=None) -> dict:
    """Device ms per decode step by CUDA-graph replay of the step's real
    launches, and us per launch at the chunk and prefill shapes; with
    ``parent``, the parent tree's K1 + K2 sequence on the same inputs."""
    from repro_torch.core.bitplane import pack_planes
    from repro_torch.core.logquant import log2_quantize

    check(len(step_calls) == len(capture) == cfg.n_layers * len(PROJ),
          f"recorded {len(step_calls)} step calls")
    layouts, k2_step, k2_plain_step, floor_step, bounds = k2_decode_step(
        torch, bm_ops, step_calls, capture)

    acts = [xs for xs, *_ in capture]

    def k1_step():           # one launch per tensor: the old convention
        for xs in acts:
            l2_ops.log2quant(xs)

    def k1_many():           # the list call
        l2_ops.log2quant_many(acts)

    def k1_plain_step():
        for xs, *_ in capture:
            log2_quantize(xs)

    def two_launch_step():   # K1, then K2 fed the codes: the old sequence
        for xs, _, _, planes, _ in capture:
            q = l2_ops.log2quant(xs)
            bm_ops.bitplane_matmul(q.exp, q.sign, planes)

    def codes_step(lay):     # the same kernel, its prologue skipped
        def run():
            for (_, exp, sign, _, _), (*_, nb), planes in zip(
                    capture, step_calls, layouts[lay]):
                bm_ops.bitplane_matmul(exp, sign, planes, nb)
        return run

    blk = params["blocks"][0]
    weights = [(blk[p] if p in ("wq", "wk", "wv", "wo") else blk["mlp"][p])
               for p in PROJ]
    mm_acts = [torch.randn((BATCH, w.shape[1]), generator=g, device=dev,
                           dtype=torch.bfloat16) for w in weights]

    def matmul_step():
        for r in range(cfg.n_layers):
            for a, w in zip(mm_acts, weights):
                torch.matmul(a, w[r])

    # the list call bit-equal to the per-tensor calls on the step's inputs,
    # its launches counted
    before = l2_ops.log2quant.launches
    flat, views = l2_ops.log2quant_many(acts)
    k1_launches = l2_ops.log2quant.launches - before
    check(k1_launches == len(l2_ops.launch_plan(acts)),
          f"K1's list call on the step's {len(acts)} activations launched "
          f"{k1_launches} times, its plan {len(l2_ops.launch_plan(acts))}")
    for i, (xs, v) in enumerate(zip(acts, views)):
        q = l2_ops.log2quant(xs)
        check(torch.equal(v.exp, q.exp) and torch.equal(v.sign, q.sign),
              f"K1's list call differs from its per-tensor call on decode "
              f"step activation {i}")

    k1_bytes = sum(c[0].numel() * (c[0].element_size() + 2) for c in capture)
    ms = {lay: graph_ms(torch, k2_step(lay)) for lay in layouts}
    ms_again = {lay: graph_ms(torch, k2_step(lay)) for lay in layouts}
    t = {
        "log2quant": {
            "ms": graph_ms(torch, k1_many, inner=K1_INNER),
            "plain_ms": graph_ms(torch, k1_plain_step),
            "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "eager_ms": eager_ms(torch, k1_many),
            "per_tensor_ms": graph_ms(torch, k1_step, inner=K1_INNER),
            "ms_one_call": graph_ms(torch, k1_many),
            "list_launches": k1_launches,
            "scope": f"one decode step's {len(capture)} scaled activations, "
                     f"M={BATCH}, in one list call ({k1_launches} launches;"
                     f" per_tensor_ms: one launch per tensor); not launched "
                     f"on the serving paths (folded into bitplane_matmul's "
                     f"prologue)"},
        "bitplane_matmul": {
            "ms": ms["unpacked"], "plain_ms": graph_ms(torch, k2_plain_step),
            "bound_ms": bounds["unpacked"][0],
            "bound_by": bounds["unpacked"][1], "library_ms": None,
            "ms_packed": ms["packed"], "bound_ms_packed": bounds["packed"][0],
            "bound_by_packed": bounds["packed"][1],
            "ms_repeat": ms_again["unpacked"],
            "ms_packed_repeat": ms_again["packed"],
            "two_launch_ms": graph_ms(torch, two_launch_step),
            "codes_in_ms": graph_ms(torch, codes_step("unpacked")),
            "codes_in_ms_packed": graph_ms(torch, codes_step("packed")),
            "launch_floor_ms": graph_ms(torch, floor_step("unpacked")),
            "launch_floor_ms_packed": graph_ms(torch, floor_step("packed")),
            "context_matmul_ms": graph_ms(torch, matmul_step),
            "eager_ms": eager_ms(torch, k2_step("unpacked")),
            "eager_ms_packed": eager_ms(torch, k2_step("packed")),
            "scope": f"one decode step: {len(step_calls)} launches, "
                     f"M={BATCH}, quantizing prologue included; ms = the "
                     f"unpacked planes phases 4, 7 and 9 serve"},
    }
    k2 = t["bitplane_matmul"]
    print(f"phase 5: one decode step (M = {BATCH}) = {len(step_calls)} "
          f"launches on the step's real inputs, CUDA-graph replay, on {card}")
    for lay in layouts:
        sfx = "" if lay == "unpacked" else "_packed"
        us = ms[lay] / len(step_calls) * 1e3
        print(f"  K2 fused, {lay} planes: {k2['ms' + sfx]:.4f} ms per step "
              f"(again {ms_again[lay]:.4f}; {us:.2f} us per launch), "
              f"bound {bounds[lay][0]:.5f} ms "
              f"({bounds[lay][1]}), issued eagerly {k2['eager_ms' + sfx]:.4f}"
              f" ms")
    print(f"  K2 plain version {k2['plain_ms']:.4f} ms; K1 then K2 fed its "
          f"codes (two launches, this tree's kernels) "
          f"{k2['two_launch_ms']:.4f} ms; context: bf16 torch.matmul of the "
          f"same {len(step_calls)} "
          f"shapes {k2['context_matmul_ms']:.4f} ms (the untruncated "
          f"product, not K2's function; the port never calls it)")
    print(f"  K2 fed the step's codes (the same kernel, prologue "
          f"skipped): unpacked {k2['codes_in_ms']:.4f} ms, packed "
          f"{k2['codes_in_ms_packed']:.4f}; launch floor (an empty kernel "
          f"of each launch's grid, block and cluster, {len(step_calls)} "
          f"graph nodes): unpacked {k2['launch_floor_ms']:.4f} ms, packed "
          f"{k2['launch_floor_ms_packed']:.4f}")
    k1 = t["log2quant"]
    print(f"  K1 alone on the step's {len(acts)} activations: list call "
          f"({k1_launches} launches, counted) {k1['ms']:.4f} ms "
          f"({K1_INNER} calls a graph; one call a graph "
          f"{k1['ms_one_call']:.4f}), one launch per tensor "
          f"{k1['per_tensor_ms']:.4f} ms, plain {k1['plain_ms']:.4f}, bound "
          f"{k1['bound_ms']:.5f} ms (bytes); list call issued eagerly "
          f"{k1['eager_ms']:.4f} ms (0 launches on the serving paths); "
          f"codes bit-equal")

    p_l2 = p_bm = None
    if parent is not None:
        p_l2, p_bm = parent_ops(parent)

        def parent_k1k2(calls, k1=True, k2=True):
            codes = [p_l2.log2quant(xs, nb) for xs, _, nb in calls]

            def run():
                for (xs, planes, nb), q in zip(calls, codes):
                    if k1:
                        q = p_l2.log2quant(xs, nb)
                    if k2:
                        p_bm.bitplane_matmul(q.exp, q.sign, planes, nb)
            return run

        step = [(xs, planes, c[3]) for (xs, _, _, planes, _), c in zip(
            capture, step_calls)]
        for (xs, planes, nb), (*_, y) in zip(step, capture):
            q = p_l2.log2quant(xs, nb)
            check(torch.equal(p_bm.bitplane_matmul(q.exp, q.sign, planes,
                                                   nb), y),
                  "the parent's K1 + K2 differ from the fused op")
        k2["parent_k1_ms"] = graph_ms(torch, parent_k1k2(step, k2=False))
        k2["parent_k2_ms"] = graph_ms(torch, parent_k1k2(step, k1=False))
        k2["parent_k1k2_ms"] = graph_ms(torch, parent_k1k2(step))
        print(f"  parent tree ({parent}), same inputs, its outputs equal: "
              f"K1 {k2['parent_k1_ms']:.4f} ms + K2 "
              f"{k2['parent_k2_ms']:.4f} ms (unpacked planes); the sequence "
              f"K1 then K2 {k2['parent_k1k2_ms']:.4f} ms per step")

    # the chunk and prefill shapes: the prefill's real activations (M =
    # BATCH x PROMPT rows), their first 128 and 64 rows, both bodies; the
    # same with the codes fed in (prologue skipped), the launch floor and,
    # with a parent tree, its K1 + K2
    rows_all = BATCH * PROMPT
    by_shape = {}
    for x, a, planes, nb in prefill_calls:
        check(x.shape[0] == rows_all, f"prefill call with {x.shape[0]} rows")
        by_shape.setdefault((x.shape[1], planes.shape[2]), []).append(
            (x, a, planes, pack_planes(planes, axis=0), nb))
    per_launch = {}
    for (kk, nn), calls in by_shape.items():
        for m in (64, 128, rows_all):
            row = {}
            codes = [log2_quantize(c[0][:m].float() / c[1]) for c in calls]

            def per_call(fn):
                return graph_ms(torch, lambda: [fn(c, q) for c, q in zip(
                    calls, codes)], reps=5) / len(calls) * 1e3

            for lay_i, lay in ((2, "unpacked"), (3, "packed")):
                for tc in (False, True):
                    body = f"{lay}_{'tc' if tc else 'int'}"
                    row[f"{body}_us"] = per_call(
                        lambda c, q: bm_ops.log2_bitplane_matmul(
                            c[0][:m], c[1], c[lay_i], c[4],
                            tensor_cores=tc))
                    row[f"{body}_codes_us"] = per_call(
                        lambda c, q: bm_ops.bitplane_matmul(
                            q.exp, q.sign, c[lay_i], c[4], tensor_cores=tc))
                    row[f"{body}_floor_us"] = per_call(
                        lambda c, q: launch_floor(
                            torch, bm_ops, m, kk, nn, c[4], lay_i == 3, tc))
                b, o = k2_bound(torch, bm_ops, codes[0].exp, nn,
                                lay == "packed", calls[0][0].element_size())
                row[f"{lay}_bound_us"] = max(b / HBM_BYTES_PER_S,
                                             o / BF16_FLOPS_PER_S) * 1e6
            auto = ("tc" if bm_ops.tensor_core_body(m, nn, calls[0][4])
                    else "int")
            row["auto"] = auto
            if p_l2 is not None:
                xs = [(c[0][:m].float() / c[1], c[2], c[4]) for c in calls]
                row["parent_k1k2_us"] = graph_ms(
                    torch, parent_k1k2(xs), reps=5) / len(calls) * 1e3
            per_launch[f"{m}x{kk}x{nn}"] = row
            print(f"  M={m} {kk}x{nn} ({len(calls)} launches of the prefill),"
                  f" us per launch: " + ", ".join(
                      f"{lay} int {row[lay + '_int_us']:.2f} / tc "
                      f"{row[lay + '_tc_us']:.2f} (bound "
                      f"{row[lay + '_bound_us']:.3f})"
                      for lay in ("unpacked", "packed"))
                  + f"; the wrapper takes {auto}"
                  + (f"; parent K1 + K2 {row['parent_k1k2_us']:.2f}"
                     if p_l2 is not None else ""))
            print(f"    codes fed in (prologue skipped), int / tc: " +
                  ", ".join(f"{lay} {row[lay + '_int_codes_us']:.2f} / "
                            f"{row[lay + '_tc_codes_us']:.2f}"
                            for lay in ("unpacked", "packed")) +
                  "; launch floor, int / tc: " +
                  ", ".join(f"{lay} {row[lay + '_int_floor_us']:.2f} / "
                            f"{row[lay + '_tc_floor_us']:.2f}"
                            for lay in ("unpacked", "packed")))
    k2["per_launch_us"] = per_launch
    return t


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


def serve_config(*, quant, kernel, stats, kv_quant=False):
    """Phase 7's ``ServeConfig`` with the run's switches."""
    from repro_torch.serving import ServeConfig

    return ServeConfig(**SERVE, attn_kernel="pallas" if kernel else "off",
                       quant="pallas" if quant else False, with_stats=stats,
                       kv_quant=kv_quant, kv_bits=KV_BITS)


def combined_record(res, run) -> dict:
    """What phase 14 holds the disaggregated runs against: each request's
    tokens, finish reason and error, and the combined run's ticks (the
    caller adds its tick graph's replay, ``replay_tick_ms``)."""
    return {"results": [(r.tokens, r.finish_reason, r.error) for r in res],
            "ticks": run["ticks"]}


def serve(torch, dev, cfg, trace, *, quant, kernel, stats, counters,
          on_tick=None, kv_quant=False, pack=False, profile=None,
          params=None):
    """Serve the trace through ServeScheduler (on ``params``, or random
    weights from seed 0, quantized when ``quant``); returns (results, sched,
    forwards, wall seconds, run).  ``counters`` are zeroed just before the
    run; ``forwards`` counts the decode steps, chunk forwards and bucketed
    prefills the scheduler's programs ran; ``run`` holds each tick's page
    table, the decode-only ticks' tokens and time, the kernel launches the
    graph replays ran (each program's capture census times its replays)
    and, with ``profile``, a profiler trace of the first tick that can only
    decode (left out of the decode-only time), and every other tick's
    host-clock seconds with whether it carried a chunk, whether it
    captured a graph and its live slots."""
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import ServeScheduler

    if params is None:
        params = init_params(cfg, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        if quant:
            params = quantize_model_params(cfg, params, pack=pack)
    sched = ServeScheduler(cfg, params, serve_config(
        quant=quant, kernel=kernel, stats=stats, kv_quant=kv_quant))
    progs = sched.programs()

    def calls(*names):
        return sum(progs[n].calls for n in names)

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
    run = {"tables": [], "decode_only": {"tokens": 0, "s": 0.0, "ticks": 0},
           "ticks": []}
    dec = run["decode_only"]
    t0 = time.perf_counter()
    while sched.pending:
        before = (generated(), calls("chunk", "mixed"), calls("prefill"))
        built = sum(len(p.entries()) for p in progs.values())
        # the first tick that can only decode: nothing queued, no slot
        # prefilling
        quiet = not sched._queue and all(
            sl is None or sl.phase == "decode" for sl in sched._slots)
        profiled = profile is not None and quiet and "share" not in profile
        slots = int(sched._active.sum())
        t1 = time.perf_counter()
        if profiled:
            profile.update(profiled_tick(torch, sched), slots=slots)
        else:
            check(sched.step_tick(), "a tick found nothing to do")
        dt = time.perf_counter() - t1
        if profiled:
            run["profiled_s"] = dt
        else:
            # each tick's host time, whether it carried a chunk, whether
            # a program captured its graph in it, and its live slots
            run["ticks"].append((dt, before[1] != calls("chunk", "mixed"),
                                 built != sum(len(p.entries())
                                              for p in progs.values()),
                                 slots))
        if not profiled and before[1:] == (calls("chunk", "mixed"),
                                           calls("prefill")):
            dec["tokens"] += generated() - before[0]
            dec["s"] += dt
            dec["ticks"] += 1
        run["tables"].append(sched._table.copy())
        if on_tick is not None:
            on_tick(sched)
    torch.cuda.synchronize()
    # the profiled tick's tracing cost is not the system's
    wall = time.perf_counter() - t0 - run.get("profiled_s", 0.0)
    ts = sched.tick_steps
    fwd = {"decode": ts * calls("tick", "mixed"),
           "chunk": calls("chunk", "mixed"), "prefill": calls("prefill")}
    replayed = {}
    for prog in progs.values():
        for k, n in prog.replayed_launches().items():
            replayed[k] = replayed.get(k, 0) + n
    run["replayed"] = replayed
    results = sched.run()
    check(len(results) == len(trace), f"{len(results)} results")
    for r in results:
        check(r.finish_reason == "length" and len(r.tokens) == SERVE_NEW
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid}: {r.finish_reason}, {len(r.tokens)} tokens")
    return results, sched, fwd, wall, run


def profiled_tick(torch, sched) -> dict:
    """One tick under ``torch.profiler`` (device activity only): its
    host-clock ms, the device time of every kernel, memcpy and memset in
    it, their share of the tick (device busy), and the top five device
    ops by time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        check(sched.step_tick(), "a tick found nothing to do")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA

    def us(e):
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))

    ops = [e for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(us(e) for e in ops) / 1e3
    top = sorted(ops, key=us, reverse=True)[:5]
    return {"wall_ms": wall, "busy_ms": busy, "share": busy / wall,
            "kernels": sum(e.count for e in ops),
            "top": [(e.key[:60], us(e) / 1e3, e.count) for e in top]}


def tick_replay_ms(torch, sched, reps: int = 5) -> float:
    """Device time of one replay of the scheduler's captured tick graph
    (after the trace drained: the replays rewrite junk rows of an idle
    pool)."""
    (entry,) = sched.programs()["tick"].entries()
    return replay_ms(torch, entry, reps)


def replay_ms(torch, entry, reps: int = 5) -> float:
    """Device time of one replay of a program's captured graph (CUDA
    events over ``reps`` replays, after one unmeasured)."""
    entry.graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        entry.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def program_report(sched, label: str) -> None:
    """Print ``compile_stats()``, each captured graph's capture ms, replays,
    launch census and kernel-node count; check the reference's bounds."""
    from repro_torch.serving import engine

    stats = sched.compile_stats()
    print(f"    {label} compile_stats {stats}")
    # the trace never leaves a tick with chunk rows and no decode row, so
    # the chunk-only program may never run; the mixed one does
    check(stats["tick"] == 1 and stats.get("chunk", 0) <= 1
          and stats.get("mixed", 0) <= 1
          and stats["prefill"] <= len(SERVE["buckets"]),
          f"compile_stats {stats} break the reference's bounds")
    for name, prog in sched.programs().items():
        for i, e in enumerate(prog.entries()):
            check(e.graph is not None and e.replays == e.calls,
                  f"{name}[{i}] ran {e.calls} times, replayed {e.replays}")
            census = {k: v for k, v in e.census.items() if v}
            nodes = engine.graph_nodes(e)
            print(f"      {name}[{i}] {tuple(e.inputs[0].shape)}: capture "
                  f"{e.capture_ms:.1f} ms, {e.replays} replays, census "
                  f"{census}, graph kernel nodes "
                  + (f"{nodes[0]} of {nodes[1]} nodes" if nodes else
                     "not available"))


def held_equal(label, graph, eager) -> None:
    """Graph run against its engine.eager() run: tokens, per-request stats
    and every tick's page table equal."""
    import numpy as np

    (gres, gsched, gfwd, _, grun), (eres, _, efwd, _, erun) = graph, eager
    check([r.tokens for r in gres] == [r.tokens for r in eres],
          f"{label}: graph tokens differ from engine.eager()'s")
    for a, b in zip(gres, eres):
        for key in ("plane_traffic_fraction", "element_traffic_fraction"):
            x, y = getattr(a, key), getattr(b, key)
            check(repr(x) == repr(y), f"{label}: request {a.rid} {key} "
                  f"{x!r} (graph) != {y!r} (eager)")
    check(gfwd == efwd and len(grun["tables"]) == len(erun["tables"])
          and all(np.array_equal(a, b) for a, b in zip(grun["tables"],
                                                       erun["tables"])),
          f"{label}: forwards {gfwd} / {efwd} or page tables differ")


def tok_s(label, res, wall, run, sched) -> dict:
    """Print a run's whole-trace and decode-only tok/s and ms per decode
    step; returns them."""
    total = sum(len(r.tokens) for r in res)
    dec = run["decode_only"]
    steps = dec["ticks"] * sched.tick_steps
    capture = sum(e.capture_ms or 0.0 for p in sched.programs().values()
                  for e in p.entries()) / 1e3
    out = {"tok_s": total / wall,
           "decode_tok_s": dec["tokens"] / max(dec["s"], 1e-9),
           "step_ms": dec["s"] / max(steps, 1) * 1e3, "capture_s": capture}
    print(f"    {label}: {total} tokens in {wall:.3f} s = {out['tok_s']:.2f} "
          f"tok/s (prefill and captures included, {capture:.3f} s of "
          f"captures; the profiled tick's "
          f"{run.get('profiled_s', 0.0):.3f} s left out); decode-only "
          f"ticks: {dec['tokens']} tokens in "
          f"{dec['s']:.3f} s = {out['decode_tok_s']:.2f} tok/s over "
          f"{dec['ticks']} ticks, {out['step_ms']:.3f} ms per decode step")
    return out


def most_pages(torch, dev):
    """``(best, on_tick)``: ``on_tick(sched)`` keeps in ``best`` the page
    table, lengths (+1, the next decode row) and K/V pool of the tick that
    touches most pages."""
    best = {"touched": -1}

    def on_tick(sched):
        lens = sched._pool["length"].cpu() + 1
        touched = int(((lens + SERVE["page_len"] - 1)
                       // SERVE["page_len"]).sum())
        if touched > best["touched"]:
            best.update(touched=touched, lens=lens.to(dev),
                        table=torch.from_numpy(sched._table.copy()).to(dev),
                        k=sched._pool["layers"][0]["k"].clone(),
                        v=sched._pool["layers"][0]["v"].clone())
    return best, on_tick


def k3_tick(torch, dev, card, cfg, pa_ops, best) -> dict:
    """K3 on the tick that touched most pages (``most_pages``): real pool,
    table and lengths, random queries; every layer held against its plain
    version, then one decode step's launches timed by CUDA-graph replay
    beside the bytes bound, the plain version and the library context."""
    from repro_torch.models.attention import _paged_gather

    lens, table = best["lens"].to(torch.int32), best["table"]
    b, nb = table.shape
    g, d = cfg.n_kv_heads, cfg.head_dim
    r = cfg.n_heads // g
    # a pool from a run cut below cfg's depth (SCHED_LAYERS) holds fewer
    # layers: a step's cfg.n_layers launches cycle over them
    pools = best["k"].shape[0]
    splits = SERVE["attn_splits"]
    gen = torch.Generator(device=dev).manual_seed(7)
    qs = [torch.randn((b, g, r, d), generator=gen, device=dev,
                      dtype=cfg.dtype) for _ in range(cfg.n_layers)]
    err = 0.0
    for layer in range(pools):
        err = max(err, k3_against_plain(
            torch, pa_ops, qs[layer], best["k"][layer], best["v"][layer],
            table, lens, splits, f"full-width tick, layer {layer}"))
    print(f"  tick with {best['touched']} touched pages (lengths "
          f"{lens.tolist()}): K3 within bf16 tolerance of its plain version "
          f"on all {pools} layers of the pool (max |diff| {err:.3e})")

    def k3_step():
        for layer in range(cfg.n_layers):
            pa_ops.paged_attention(qs[layer], best["k"][layer % pools],
                                   best["v"][layer % pools], table, lens,
                                   splits)

    def plain_step():
        for layer in range(cfg.n_layers):
            pa_ops.paged_attention_plain(qs[layer], best["k"][layer % pools],
                                         best["v"][layer % pools], table,
                                         lens, splits)

    valid = (torch.arange(nb * SERVE["page_len"], device=dev)[None]
             < lens[:, None])[:, None, None, :]          # (B, 1, 1, S)

    def library_step():
        for layer in range(cfg.n_layers):
            kg = _paged_gather(best["k"][layer % pools], table).transpose(1, 2)
            vg = _paged_gather(best["v"][layer % pools], table).transpose(1, 2)
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
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib_ms, eager_ms=eager, max_abs_err=err,
                scope=f"one decode step: {cfg.n_layers} launches, B={b}, "
                      f"G={g}, R={r}, D={d}, {touched} touched pages, "
                      f"splits {splits}")




def phase7(torch, dev, card, pa_ops, l2_ops, bm_ops) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

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
    # compared too.  The audit synchronises with the host, so these runs
    # go through engine.eager(), at the first F32_LAYERS of the 30 layers
    # (to keep the script's time)
    c32 = cfg.replace(dtype=torch.float32, n_layers=F32_LAYERS)
    for quant in (False, True):
        toks = {}
        for kernel in (False, True):
            audit = {"calls": 0, "err": 0.0, "bad": 0, "flips": 0}
            inner = pa_ops.paged_decode_attention
            if kernel:
                pa_ops.paged_decode_attention = audited(torch, inner, audit)
            try:
                with engine.eager():
                    res, _, fwd, wall, _ = serve(
                        torch, dev, c32, trace, quant=quant, kernel=kernel,
                        stats=False, counters=kernels)
            finally:
                pa_ops.paged_decode_attention = inner
            want = c32.n_layers * fwd["decode"] if kernel else 0
            check(pa_ops.paged_attention.launches == want,
                  f"K3 launched {pa_ops.paged_attention.launches} times, "
                  f"expected {want}")
            check(audit["calls"] == want and audit["bad"] == 0,
                  f"K3 against the gather oracle: {audit}")
            toks[kernel] = [r.tokens for r in res]
            print(f"  f32 {'quant' if quant else 'float'}, {c32.n_layers} "
                  f"layers, {'K3' if kernel else 'gather'} (engine.eager()): "
                  f"{wall:.3f} s, {fwd}"
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

    # bf16 K3 float, then the main path: K3 quantized with stats; each as
    # CUDA-graph programs over the whole model, then its first CUT_LAYERS
    # layers as graphs and under engine.eager(), held equal (an eager run
    # at 30 layers took 24 s float and 97 s quantized)
    best, on_tick = most_pages(torch, dev)
    params = init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)

    out = {"serve": {}}
    for quant in (False, True):
        tag = "quant+stats" if quant else "float"
        p = quantize_model_params(cfg, params) if quant else params
        ccfg, cparams = first_layers(cfg, p, CUT_LAYERS)
        plan = (("graph", cfg, p), ("cut/graph", ccfg, cparams),
                ("cut/eager", ccfg, cparams))
        runs, profile = {}, {} if quant else None
        for mode, c, pp in plan:
            with (engine.eager() if mode.endswith("eager")
                  else contextlib.nullcontext()):
                runs[mode] = serve(
                    torch, dev, c, trace, quant=quant, kernel=True,
                    stats=quant, counters=kernels, params=pp,
                    profile=profile if mode == "graph" else None,
                    on_tick=on_tick if quant and mode == "graph" else None)
            res, sched, fwd, wall, run = runs[mode]
            launches = (run["replayed"] if mode.endswith("graph") else
                        {k.__name__: k.launches for k in kernels})
            n_fwd = sum(fwd.values())
            check(launches["paged_attention"] == c.n_layers * fwd["decode"],
                  f"{mode}: K3 launches {launches['paged_attention']} != "
                  f"{c.n_layers} x {fwd['decode']} decode forwards")
            if quant:
                per_fwd = c.n_layers * len(PROJ)
                check(launches["bitplane_matmul"] == per_fwd * n_fwd
                      and launches["log2quant"] == 0,
                      f"{mode}: K2 launched {launches['bitplane_matmul']} "
                      f"times, expected {per_fwd} x {n_fwd} forwards, and K1 "
                      f"{launches['log2quant']}, expected 0")
            else:
                check(launches["log2quant"] == launches["bitplane_matmul"]
                      == 0, f"{mode}: the float run launched a quantized "
                      f"kernel")
            counted = {k.__name__: k.launches for k in kernels}
            print(f"  bf16 {tag} K3, {mode} ({c.n_layers} layers): forwards "
                  f"{fwd}; launches "
                  + (f"replayed (capture census x replays) {launches}; "
                     f"counted by the wrappers in the warm-ups and "
                     f"captures {counted}" if mode.endswith("graph")
                     else f"{launches}"))
            out["serve"][f"{tag}/{mode}"] = tok_s(
                f"bf16 {tag} {mode} ({c.n_layers} layers)", res, wall, run,
                sched)
            if mode == "graph":
                if not quant:
                    out["combined"] = combined_record(res, run)
                program_report(sched, f"bf16 {tag} graph")
                rep = tick_replay_ms(torch, sched)
                if not quant:
                    out["combined"]["replay_tick_ms"] = rep
                out["serve"][f"{tag}/graph"]["replay_step_ms"] = \
                    rep / sched.tick_steps
                print(f"    tick graph replayed alone: {rep:.3f} ms device "
                      f"time = {rep / sched.tick_steps:.3f} ms per decode "
                      f"step (CUDA events, {card})")
                if quant:
                    out["launches"] = launches["paged_attention"]
            st = sched.prefix_cache_stats()
            check(st["cached_tokens"] > 0 and st["cached_tokens"] % 16 != 0,
                  f"prefix cache stats {st}: expected whole-page and "
                  f"copy-on-write hits")
            if mode == "graph":
                print(f"    prefix cache: hit_rate {st['hit_rate']:.6f}, "
                      f"cached_tokens {st['cached_tokens']:.0f}/"
                      f"{st['prompt_tokens']:.0f}, lookups hit "
                      f"{st['lookup_hits']:.0f}/{st['lookups']:.0f}, "
                      f"pages_in_use {st['pages_in_use']:.0f}")
            if quant and mode == "graph":
                tile = sum(r.plane_traffic_fraction for r in res) / len(res)
                elem = sum(r.element_traffic_fraction for r in res) / len(res)
                check(0 < elem <= tile <= 1,
                      f"traffic fractions {tile} {elem}")
                print(f"    mean per-request plane_traffic_fraction "
                      f"{tile:.6f}, element_traffic_fraction {elem:.6f}")
        held_equal(f"bf16 {tag}, {CUT_LAYERS} layers", runs["cut/graph"],
                   runs["cut/eager"])
        print(f"  bf16 {tag}: at the first {CUT_LAYERS} of {cfg.n_layers} "
              f"layers the graph run equals its engine.eager() run in "
              f"tokens, per-request stats, forwards and every tick's page "
              f"table; decode step "
              f"{out['serve'][f'{tag}/cut/eager']['step_ms']:.3f} ms eager "
              f"-> {out['serve'][f'{tag}/cut/graph']['step_ms']:.3f} ms "
              f"graph there (host clock)")
        if quant:
            check("share" in profile, "graph: no tick was profiled")
            print(f"    profiled decode-only tick, graph ({profile['slots']} "
                  f"slots, {card}): {profile['wall_ms']:.3f} ms on the host "
                  f"clock, device busy {profile['busy_ms']:.3f} ms "
                  f"({profile['kernels']} device ops) = share "
                  f"{profile['share']:.4f}; top five device ops "
                  f"{[(n, round(ms, 4), c) for n, ms, c in profile['top']]}")
            out["serve"][f"{tag}/graph"]["busy_share"] = profile["share"]
        del runs, p, cparams

    out.update(k3_tick(torch, dev, card, cfg, pa_ops, best))
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
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine
    from repro_torch.serving.kvpool import (blocks_for_tokens, page_kv_bytes,
                                            tail_ring_bytes)

    cfg = get_config("smollm-135m")
    trace = serve_trace(cfg.vocab_size)
    pl, splits = SERVE["page_len"], SERVE["attn_splits"]
    kernels = (pa_ops.paged_attention, pa_ops.paged_attention_quant,
               l2_ops.log2quant, bm_ops.bitplane_matmul)
    print(f"phase 9: ServeScheduler as phase 7 with kv_quant=True, "
          f"kv_bits={KV_BITS}")

    # f32, float projections, cut in depth: the quantized-gather read and
    # K4, through engine.eager() (the audit and the digests synchronise
    # with the host)
    c32 = cfg.replace(dtype=torch.float32, n_layers=F32_LAYERS)
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
            with engine.eager():
                res, _, fwd, wall, _ = serve(
                    torch, dev, c32, trace, quant=False, kernel=kernel,
                    stats=False, counters=kernels, kv_quant=True)
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
        print(f"  f32 float kv_quant, {c32.n_layers} layers, "
              f"{'K4' if kernel else 'gather'} (engine.eager()): "
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

    # bf16, quant=True on packed planes (the deploy format), K4: the
    # slice's main path as CUDA-graph programs over the whole model, then
    # its first CUT_LAYERS layers as graphs and under engine.eager() (an
    # eager run at 30 layers took 88 s); after every tick of those two a
    # digest of the code and scale pages (the trash page left out)
    best = {"touched": -1}
    weights = {}

    def tick_digest(sched, out):
        layer = sched._pool["layers"][0]
        sums = []
        for k in ("k_codes", "v_codes", "k_scale", "v_scale"):
            flat = layer[k][:, 1:].reshape(-1)
            w = weights.get(flat.numel())
            if w is None:
                w = weights[flat.numel()] = torch.arange(
                    flat.numel(), device=flat.device) % 65521 + 1
            sums.append((flat.long() * w).sum())
        out.append(torch.stack(sums))

    def snapshot(sched):
        lens = sched._pool["length"].cpu() + 1
        touched = int(((lens - 1) // pl).sum())
        if touched > best["touched"]:
            layer = sched._pool["layers"][0]
            best.update(touched=touched, lens=lens.to(dev),
                        table=torch.from_numpy(sched._table.copy()).to(dev),
                        **{k: layer[k].clone() for k in (
                            "k_codes", "k_scale", "v_codes", "v_scale")})

    pparams = quantize_model_params(cfg, init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev), pack=True)
    ccfg, cparams = first_layers(cfg, pparams, CUT_LAYERS)
    plan = (("graph", cfg, pparams), ("cut/graph", ccfg, cparams),
            ("cut/eager", ccfg, cparams))
    runs, tick_digests, serve_out = {}, {}, {}
    for mode, c, pp in plan:
        tick_digests[mode] = []
        with (engine.eager() if mode.endswith("eager")
              else contextlib.nullcontext()):
            runs[mode] = serve(
                torch, dev, c, trace, quant=True, kernel=True, stats=False,
                counters=kernels, kv_quant=True, params=pp,
                on_tick=snapshot if mode == "graph" else
                (lambda sc, m=mode: tick_digest(sc, tick_digests[m])))
        res, sched, fwd, wall, run = runs[mode]
        launches = (run["replayed"] if mode.endswith("graph") else
                    {k.__name__: k.launches for k in kernels})
        n_fwd = sum(fwd.values())
        check(launches["paged_attention_quant"] == c.n_layers
              * fwd["decode"] and launches["paged_attention"] == 0,
              f"{mode}: K4 launches {launches} != {c.n_layers} x "
              f"{fwd['decode']} decode forwards")
        check(launches["bitplane_matmul"] == c.n_layers * len(PROJ) * n_fwd
              and launches["log2quant"] == 0,
              f"{mode}: K2 launched {launches['bitplane_matmul']} times, "
              f"expected {c.n_layers * len(PROJ)} x {n_fwd} forwards, and "
              f"K1 {launches['log2quant']}, expected 0")
        print(f"  bf16 quant (packed planes) kv_quant K4, {mode} "
              f"({c.n_layers} layers): forwards {fwd}; launches "
              + ("replayed (capture census x replays) "
                 if mode.endswith("graph") else "") + f"{launches}")
        serve_out[mode] = tok_s(f"{mode} ({c.n_layers} layers)", res, wall,
                                run, sched)
        if mode == "graph":
            program_report(sched, "graph")
            rep = tick_replay_ms(torch, sched)
            serve_out["graph"]["replay_step_ms"] = rep / sched.tick_steps
            print(f"    tick graph replayed alone: {rep:.3f} ms device time "
                  f"= {rep / sched.tick_steps:.3f} ms per decode step (CUDA "
                  f"events, {card})")
            out_launches = launches["paged_attention_quant"]
            st = sched.prefix_cache_stats()
            combined = dict(combined_record(res, run), replay_tick_ms=rep)
    held_equal(f"phase 9 bf16, {CUT_LAYERS} layers", runs["cut/graph"],
               runs["cut/eager"])
    gd, ed = (torch.stack(tick_digests[m]).cpu()
              for m in ("cut/graph", "cut/eager"))
    check(torch.equal(gd, ed), "phase 9: the graph run's code and scale "
          "pages differ from engine.eager()'s after some tick")
    print(f"  bf16 kv_quant: at the first {CUT_LAYERS} of {cfg.n_layers} "
          f"layers the graph run equals its engine.eager() run in tokens, "
          f"forwards, every tick's page table and every tick's code and "
          f"scale pages ({len(gd)} digests); decode step "
          f"{serve_out['cut/eager']['step_ms']:.3f} ms eager -> "
          f"{serve_out['cut/graph']['step_ms']:.3f} ms graph there (host "
          f"clock)")
    del runs, pparams, cparams
    check(st["cached_tokens"] > 0 and st["cached_tokens"] % pl != 0,
          f"prefix cache stats {st}: expected whole-page and copy-on-write "
          f"hits")
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
    return dict(launches=out_launches, serve=serve_out, combined=combined,
                ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib_ms, context_whole_pool_ms=pool_ms,
                eager_ms=eager, max_abs_err=err,
                scope=f"one decode step: {cfg.n_layers} launches, B={b}, "
                      f"{full} full pages, splits {splits}, n_bits "
                      f"{KV_BITS}")


def mamba_model(torch, dev, bm_ops) -> dict:
    """Full-width mamba2-780m in bf16 from seed 0 (phases 5 and 10): its
    params, quantized on unpacked and on packed planes, the prompt, and
    the K2 calls of one quantized prefill and of one decode step, whose
    codes and outputs are held against K1's and K2's plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.core.logquant import LogQuantized, log2_quantize
    from repro_torch.core.shiftadd import QuantCtx, shiftadd_matmul_bitplane
    from repro_torch.models.model import init_caches, init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

    t0 = time.perf_counter()
    cfg = get_config("mamba2-780m")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    qparams = quantize_model_params(cfg, params)
    pparams = quantize_model_params(cfg, params, pack=True)
    caches = init_caches(cfg, BATCH, PROMPT + 1, device=dev)
    prefill_calls = recorded(bm_ops, lambda: engine.make_prefill_step(
        cfg, True)(qparams, {"tokens": prompt}, caches))
    logits, caches = prefill_calls.result
    ctx = QuantCtx(capture=[])
    step_calls = recorded(bm_ops, lambda: engine.make_serve_step(cfg, ctx)(
        qparams, caches, torch.argmax(logits, -1).to(torch.int32)[:, None]))
    step_logits, _ = step_calls.result
    n = cfg.n_layers * len(MAMBA_PROJ)
    check(len(step_calls) == len(ctx.capture) == len(prefill_calls) == n,
          f"mamba: {len(prefill_calls)} prefill and {len(step_calls)} step "
          f"calls of K2, expected {n} each")
    check(bool(torch.isfinite(logits.float()).all()
               and torch.isfinite(step_logits.float()).all()),
          "mamba: non-finite logits")
    for i, (xs, exp, sign, planes, y) in enumerate(ctx.capture):
        what = f"mamba layer {i // 3} {MAMBA_PROJ[i % 3]}"
        ref = log2_quantize(xs)
        check(torch.equal(exp, ref.exp) and torch.equal(sign, ref.sign),
              f"K2's codes differ from K1's plain version on {what}")
        check(torch.equal(y, shiftadd_matmul_bitplane(
            LogQuantized(exp, sign), planes)),
            f"K2 differs from its plain version on {what}")
    torch.cuda.synchronize()
    print(f"mamba2-780m: {cfg.n_layers}L d={cfg.d_model} "
          f"{cfg.ssm_heads} SSD heads x {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, vocab {cfg.vocab_size}, {cfg.dtype}, seed 0: "
          f"built and quantized (unpacked and packed planes) in "
          f"{time.perf_counter() - t0:.1f} s; one decode step's {n} K2 "
          f"launches (M = {BATCH}) bit-equal to K1's and K2's plain versions "
          f"on their real activations")
    return dict(cfg=cfg, params=params, qparams=qparams, pparams=pparams,
                prompt=prompt, prefill_calls=prefill_calls,
                step_calls=step_calls, capture=ctx.capture)


def phase5_mamba(torch, dev, card, mb, bm_ops) -> dict:
    """K2 at the mamba2-780m shapes: one decode step's 144 launches by
    CUDA-graph replay beside their bound, and us per launch of both
    bodies at ``MAMBA_M`` rows of the prefill's real activations."""
    from repro_torch.core.bitplane import pack_planes
    from repro_torch.core.logquant import log2_quantize

    cfg, step_calls, capture = mb["cfg"], mb["step_calls"], mb["capture"]
    layouts, k2_step, plain_step, floor_step, bounds = k2_decode_step(
        torch, bm_ops, step_calls, capture)

    weights = [mb["params"]["blocks"][0][p] for p in MAMBA_PROJ]
    acts = [torch.randn((BATCH, w.shape[1]), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev, dtype=torch.bfloat16)
        for w in weights]

    def matmul_step():
        for r in range(cfg.n_layers):
            for a, w in zip(acts, weights):
                torch.matmul(a, w[r])

    ms = {lay: graph_ms(torch, k2_step(lay)) for lay in layouts}
    t = {"ms": ms["unpacked"], "ms_packed": ms["packed"],
         "plain_ms": graph_ms(torch, plain_step),
         "bound_ms": bounds["unpacked"][0], "bound_by": bounds["unpacked"][1],
         "bound_ms_packed": bounds["packed"][0],
         "bound_by_packed": bounds["packed"][1], "library_ms": None,
         "eager_ms": eager_ms(torch, k2_step("unpacked")),
         "eager_ms_packed": eager_ms(torch, k2_step("packed")),
         "launch_floor_ms": graph_ms(torch, floor_step("unpacked")),
         "launch_floor_ms_packed": graph_ms(torch, floor_step("packed")),
         "context_matmul_ms": graph_ms(torch, matmul_step),
         "scope": f"one mamba2-780m decode step: {len(step_calls)} launches "
                  f"(48 layers x wz, wx, out_proj), M={BATCH}"}
    print(f"phase 5, mamba2-780m shapes: one decode step (M = {BATCH}) = "
          f"{len(step_calls)} launches on the step's real inputs, CUDA-graph "
          f"replay, on {card}")
    for lay in layouts:
        sfx = "" if lay == "unpacked" else "_packed"
        print(f"  K2 {lay} planes: {t['ms' + sfx]:.4f} ms per step "
              f"({t['ms' + sfx] / len(step_calls) * 1e3:.2f} us per launch), "
              f"bound {t['bound_ms' + sfx]:.5f} ms ({t['bound_by' + sfx]}), "
              f"issued eagerly {t['eager_ms' + sfx]:.4f} ms, launch floor "
              f"{t['launch_floor_ms' + sfx]:.4f} ms")
    print(f"  K2 plain version {t['plain_ms']:.4f} ms; context: bf16 "
          f"torch.matmul of the same {len(step_calls)} shapes "
          f"{t['context_matmul_ms']:.4f} ms (not K2's function; the port "
          f"never calls it)")

    by_shape = {}
    for x, a, planes, nb in mb["prefill_calls"]:
        by_shape.setdefault((x.shape[1], planes.shape[2]), []).append(
            (x, a, planes, pack_planes(planes, axis=0), nb))
    per_launch = {}
    for (kk, nn), calls in sorted(by_shape.items()):
        for m in MAMBA_M:
            row = {}
            codes = [log2_quantize(c[0][:m].float() / c[1]) for c in calls]
            for lay_i, lay in ((2, "unpacked"), (3, "packed")):
                for tc in (False, True):
                    row[f"{lay}_{'tc' if tc else 'int'}_us"] = graph_ms(
                        torch, lambda: [bm_ops.log2_bitplane_matmul(
                            c[0][:m], c[1], c[lay_i], c[4], tensor_cores=tc)
                            for c in calls], reps=5) / len(calls) * 1e3
                b, o = k2_bound(torch, bm_ops, codes[0].exp, nn,
                                lay == "packed", calls[0][0].element_size())
                row[f"{lay}_bound_us"] = max(b / HBM_BYTES_PER_S,
                                             o / BF16_FLOPS_PER_S) * 1e6
            auto = "tc" if bm_ops.tensor_core_body(m, nn, 4) else "int"
            fast = {lay: min(("int", "tc"),
                             key=lambda b: row[f"{lay}_{b}_us"])
                    for lay in ("unpacked", "packed")}
            row.update(auto=auto, faster=fast,
                       switch_holds=all(f == auto for f in fast.values()))
            per_launch[f"{m}x{kk}x{nn}"] = row
            print(f"  M={m} {kk}x{nn} ({len(calls)} launches), us per "
                  f"launch: " + ", ".join(
                      f"{lay} int {row[lay + '_int_us']:.2f} / tc "
                      f"{row[lay + '_tc_us']:.2f} (bound "
                      f"{row[lay + '_bound_us']:.3f})"
                      for lay in ("unpacked", "packed"))
                  + f"; the switch takes {auto}, the faster is "
                  f"{fast['unpacked']} unpacked / {fast['packed']} packed: "
                  + ("holds" if row["switch_holds"] else "does not hold"))
    t["per_launch_us"] = per_launch
    held = sum(r["switch_holds"] for r in per_launch.values())
    print(f"  tensor-core switch (TC_MIN_ROWS {bm_ops.TC_MIN_ROWS}, "
          f"TC_MIN_OUTPUTS {bm_ops.TC_MIN_OUTPUTS}) takes the faster body "
          f"on both layouts at {held} of {len(per_launch)} mamba shapes "
          f"(informational; not retuned here)")
    return t


def mamba_step_bytes(cfg, batch: int, tile_fraction: float) -> dict:
    """Bytes one mamba decode step of ``batch`` rows moves, from the
    model's shapes: each weight or plane read once, the SSM state and
    conv window read and written once.  ``planes_read`` scales the packed
    planes by the step's tile-granular traffic fraction (the skip rule)."""
    d, di, n, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.conv_width)
    conv_dim = di + 2 * n
    el = 2                                          # bf16
    layers = cfg.n_layers
    qproj = 2 * d * di + di * d                     # wz, wx, out_proj
    other = (d * (2 * n + h) + w * conv_dim + conv_dim + di + d) * el \
        + 3 * h * 4                                 # wb wc wdt conv norms
    out = {
        "float_projections": layers * qproj * el,
        "planes_unpacked": layers * 8 * qproj,
        "planes_packed": layers * qproj,
        "planes_read_packed": layers * qproj * tile_fraction,
        "float_other_weights": layers * other,
        "lm_head": cfg.vocab_size * d * el,
        "ssm_state_rw": 2 * batch * layers * h * cfg.ssm_head_dim * n * 4,
        "conv_state_rw": 2 * batch * layers * (w - 1) * conv_dim * el,
    }
    state = out["ssm_state_rw"] + out["conv_state_rw"]
    rest = out["float_other_weights"] + out["lm_head"]
    out["step_float"] = out["float_projections"] + rest + state
    out["step_packed"] = out["planes_packed"] + rest + state
    out["state_share_packed"] = state / out["step_packed"]
    return out


def one_shot(torch, dev, cfg, prompt, variants, kernels, per_fwd,
             label, cut=False) -> dict:
    """Each ``(tag, params, quant, stats)`` of ``variants`` through
    ``greedy_generate`` (BATCH x PROMPT, NEW tokens) as one program: its
    first call captures, the second replays (launches = census x replays;
    no wrapper counts a launch), then the same body under
    ``engine.eager()``.  Held equal in tokens and stats; K2 launches
    ``per_fwd`` x NEW when quantized (by census x replays and by the
    wrappers' counts), K1, K3 and K4 none.  With ``cut`` the eager run and
    the graph it is held against take the model's first ``CUT_LAYERS``
    layers (phases 10-12: a full-depth eager run took 6-25 s on a slow
    host), as the schedulers' checks do.  Prints and returns each run."""
    from repro_torch.serving import engine

    runs = {}
    new = BATCH * NEW
    for tag, p, quant, stats in variants:
        def call(c=cfg, p=p, quant=quant, stats=stats):
            return engine.greedy_generate(c, p, prompt, NEW, quant=quant,
                                          with_stats=stats)
        _, t_cap = sync_time(torch, call)
        (entry,) = engine.generate_fn(cfg, p, NEW, 0.0, quant, None, stats,
                                      dev).program.entries()
        before = entry.replays
        for k in kernels:
            k.launches = 0
        out, t_graph = sync_time(torch, call)
        replayed = {k: n * (entry.replays - before)
                    for k, n in entry.census.items()}
        check(all(k.launches == 0 for k in kernels),
              f"{label} {tag}: a kernel ran outside the graph replay")
        graph_out, layers = out, cfg.n_layers
        if cut:
            ccfg, cparams = first_layers(cfg, p, CUT_LAYERS)
            layers = ccfg.n_layers
            graph_out = call(ccfg, cparams)        # captures, then replays
            for k in kernels:
                k.launches = 0
        with engine.eager():
            eout, t_eager = sync_time(
                torch, (lambda: call(ccfg, cparams)) if cut else call)
        counted = {k.__name__: k.launches for k in kernels}
        want = per_fwd * NEW if quant else 0
        for got, how, n in ((replayed, "replayed", want),
                            (counted, "eager", want // cfg.n_layers * layers)):
            check(got["bitplane_matmul"] == n and got["log2quant"] == 0
                  and got["paged_attention"] == 0
                  and got["paged_attention_quant"] == 0,
                  f"{label} {tag} {how}: launches {got}, expected K2 {n} "
                  f"and no other kernel")
        toks, st = out if stats else (out, None)
        gtoks, gst = graph_out if stats else (graph_out, None)
        etoks, est = eout if stats else (eout, None)
        check(torch.equal(gtoks, etoks) and (not stats or all(
            torch.equal(gst[k], est[k]) for k in gst)),
            f"{label} {tag}: graph tokens or stats differ from eager's "
            f"({layers} layers)")
        check(toks.shape == (BATCH, NEW) and bool((toks >= 0).all())
              and bool((toks < cfg.vocab_size).all()),
              f"{label} {tag}: bad tokens")
        runs[tag] = r = dict(toks=toks, stats=st, t_cap=t_cap,
                             t_graph=t_graph, t_eager=t_eager,
                             replayed=replayed, capture_ms=entry.capture_ms,
                             nodes=engine.graph_nodes(entry),
                             eager_layers=layers)
        nodes = r["nodes"]
        print(f"  one-shot {tag}: graph replay {t_graph:.4f} s = "
              f"{new / t_graph:.1f} tok/s; engine.eager() "
              + (f"at the first {layers} layers " if cut else "")
              + f"{t_eager:.4f} s = {new / t_eager:.1f} tok/s; first call "
              f"{t_cap:.3f} s (capture {entry.capture_ms:.1f} ms); graph "
              f"kernel nodes "
              + (f"{nodes[0]} of {nodes[1]}" if nodes else "not available")
              + f"; launches replayed {replayed}; tokens and stats equal to "
              f"engine.eager()'s" + (f" at {layers} layers" if cut else ""))
    return runs


def step_programs(torch, dev, cfg, prompt, variants, per_fwd) -> dict:
    """One decode step (B = BATCH, after a PROMPT prefill) of each
    ``(tag, params, quant)`` as its own program: its graph's kernel nodes
    and census, the device ms of one replay, the ms issued eagerly."""
    from repro_torch.models.model import init_caches
    from repro_torch.serving import engine

    steps = {}
    for tag, p, quant in variants:
        caches = init_caches(cfg, BATCH, PROMPT + NEW, device=dev)
        logits, caches = engine.make_prefill_step(cfg, quant)(
            p, {"tokens": prompt}, caches)
        step = engine.make_serve_step(cfg, quant)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        prog = engine.Program(
            lambda t, p=p, caches=caches, step=step: (step(p, caches, t)[0],),
            name=f"step_{tag}", device=dev,
            carry=[t for c in caches["layers"] for t in c.values()])
        prog(tok)
        (entry,) = prog.entries()
        check(entry.census["bitplane_matmul"] == (per_fwd if quant else 0),
              f"{cfg.name} step {tag}: census {entry.census}")
        r_ms = replay_ms(torch, entry, reps=10)
        with engine.eager():
            e_ms = eager_ms(torch, lambda: prog(tok))
        nodes = engine.graph_nodes(entry)
        steps[tag] = {"replay_ms": r_ms, "eager_ms": e_ms, "nodes": nodes}
        print(f"  one decode step ({tag}, B={BATCH}) as one graph: "
              f"{r_ms:.4f} ms device time replayed, {e_ms:.4f} ms issued "
              f"eagerly; graph kernel nodes "
              + (f"{nodes[0]} of {nodes[1]} ({nodes[0] / cfg.n_layers:.1f} "
                 f"per layer)" if nodes else "not available"))
        del prog, entry, caches
    return steps


def phase10(torch, dev, card, mb, l2_ops, bm_ops, pa_ops) -> dict:
    from repro_torch.serving import ServeConfig, ServeScheduler, engine

    t_phase = time.perf_counter()
    cfg, prompt = mb["cfg"], mb["prompt"]
    kernels = (l2_ops.log2quant, bm_ops.bitplane_matmul,
               pa_ops.paged_attention, pa_ops.paged_attention_quant)
    per_fwd = cfg.n_layers * len(MAMBA_PROJ)
    print(f"phase 10: {cfg.name} full width, bf16, one-shot batch {BATCH}, "
          f"prompt {PROMPT}, {NEW} new tokens; then phase 7's trace through "
          f"ServeScheduler; on {card}")

    # -- one-shot: float, quantized with stats, packed planes -------------
    runs = one_shot(torch, dev, cfg, prompt, (
        ("float", mb["params"], False, False),
        ("quant+stats", mb["qparams"], True, True),
        ("packed", mb["pparams"], True, False)), kernels, per_fwd, "mamba",
        cut=True)
    check(torch.equal(runs["packed"]["toks"], runs["quant+stats"]["toks"]),
          "mamba: packed-plane tokens differ from unpacked")
    tile = runs["quant+stats"]["stats"]["plane_traffic_fraction"].cpu()
    elem = runs["quant+stats"]["stats"]["element_traffic_fraction"].cpu()
    check(bool((tile[:-1] > 0).all() and (tile[:-1] <= 1).all()
               and (elem[:-1] > 0).all() and (elem <= tile + 1e-6).all()
               and tile[-1] == 0), f"mamba: bad traffic stats {tile} {elem}")
    new = BATCH * NEW
    print(f"  K2 = {cfg.n_layers} layers x {len(MAMBA_PROJ)} projections x "
          f"{NEW} forwards = {per_fwd * NEW} launches per quantized run, by "
          f"census x replays and by the wrappers in the eager run; packed "
          f"tokens equal unpacked; plane traffic per decode step: tile "
          f"{float(tile[:-1].mean()):.6f}, element "
          f"{float(elem[:-1].mean()):.6f}")

    # -- one decode step as its own program: nodes, device and eager ms ---
    steps = step_programs(torch, dev, cfg, prompt, (
        ("float", mb["params"], False), ("quant", mb["qparams"], True),
        ("packed", mb["pparams"], True)), per_fwd)

    sb = mamba_step_bytes(cfg, BATCH, float(tile[:-1].mean()))
    print(f"  bytes per decode step at batch {BATCH} (from the model's "
          f"shapes): float wz/wx/out_proj {sb['float_projections'] / 1e9:.4f}"
          f" GB, their planes unpacked {sb['planes_unpacked'] / 1e9:.4f} GB /"
          f" packed {sb['planes_packed'] / 1e9:.4f} GB (packed tiles the skip"
          f" rule reads {sb['planes_read_packed'] / 1e9:.4f} GB); other float"
          f" weights {sb['float_other_weights'] / 1e9:.4f} GB, tied lm head "
          f"{sb['lm_head'] / 1e9:.4f} GB; SSM state read + written "
          f"{sb['ssm_state_rw'] / 1e9:.4f} GB, conv window "
          f"{sb['conv_state_rw'] / 1e9:.6f} GB; a packed quantized step "
          f"{sb['step_packed'] / 1e9:.4f} GB, of which state "
          f"{sb['state_share_packed']:.4f}; a float step "
          f"{sb['step_float'] / 1e9:.4f} GB")

    # -- the scheduler: phase 7's trace, quantized on packed planes -------
    trace = serve_trace(cfg.vocab_size)
    snaps = {"n": 0}
    snap = ServeScheduler._snap_slot

    def counting(self, i):
        snaps["n"] += 1
        return snap(self, i)

    # the whole model as graphs (the measured path), then its first
    # CUT_LAYERS layers as graphs and under engine.eager(), held equal
    ccfg, cparams = first_layers(cfg, mb["pparams"], CUT_LAYERS)
    plan = (("graph", cfg, None), ("cut/graph", ccfg, cparams),
            ("cut/eager", ccfg, cparams))
    sruns, taken = {}, {}
    ServeScheduler._snap_slot = counting
    try:
        for mode, c, p in plan:
            snaps["n"] = 0
            with (engine.eager() if mode.endswith("eager")
                  else contextlib.nullcontext()):
                sruns[mode] = serve(torch, dev, c, trace, quant=True,
                                    kernel=False, stats=True,
                                    counters=kernels, pack=True, params=p)
            taken[mode] = snaps["n"]
    finally:
        ServeScheduler._snap_slot = snap
    serve_out = {"one_shot": {tag: {
        "graph_tok_s": new / r["t_graph"], "eager_tok_s": new / r["t_eager"],
        "capture_ms": r["capture_ms"]} for tag, r in runs.items()},
        "decode_step": steps, "step_bytes": sb}
    for mode, c, _ in plan:
        res, sched, fwd, wall, run = sruns[mode]
        launches = (run["replayed"] if mode.endswith("graph") else
                    {k.__name__: k.launches for k in kernels})
        n_fwd = sum(fwd.values())
        k2_fwd = c.n_layers * len(MAMBA_PROJ)
        check(launches["bitplane_matmul"] == k2_fwd * n_fwd
              and launches["log2quant"] == 0
              and launches["paged_attention"] == 0
              and launches["paged_attention_quant"] == 0,
              f"mamba scheduler {mode}: launches {launches}, expected K2 "
              f"{k2_fwd} x {n_fwd} forwards and no other kernel")
        print(f"  scheduler packed quant+stats, {mode} ({c.n_layers} "
              f"layers): forwards {fwd}; launches {launches}; snapshots "
              f"taken {taken[mode]}")
        serve_out[f"scheduler/{mode}"] = tok_s(
            f"mamba packed quant+stats {mode} ({c.n_layers} layers)", res,
            wall, run, sched)
        st = sched.prefix_cache_stats()
        serve_out[f"scheduler/{mode}"].update(
            hit_rate=st["hit_rate"], snapshots=taken[mode])
        if mode == "graph":
            program_report(sched, "mamba packed quant+stats graph")
            rep = tick_replay_ms(torch, sched)
            (tick,) = sched.programs()["tick"].entries()
            nodes = engine.graph_nodes(tick)
            per_step = rep / sched.tick_steps
            host = serve_out["scheduler/graph"]["step_ms"]
            serve_out["scheduler/graph"].update(
                replay_step_ms=per_step,
                nodes_per_step=(nodes[0] / sched.tick_steps if nodes
                                else None))
            print(f"    tick graph replayed alone: {rep:.3f} ms device time "
                  f"= {per_step:.3f} ms per decode step of "
                  f"{sched.max_slots} slots (CUDA events, {card}); "
                  + (f"{nodes[0] / sched.tick_steps:.0f} kernel nodes per "
                     f"step; " if nodes else "")
                  + f"device time / host time per decode step "
                  f"{per_step / max(host, 1e-9):.4f}")
            print(f"    prefix cache: hit_rate {st['hit_rate']:.6f}, "
                  f"cached_tokens {st['cached_tokens']:.0f}/"
                  f"{st['prompt_tokens']:.0f}, lookups hit "
                  f"{st['lookup_hits']:.0f}/{st['lookups']:.0f}; "
                  f"snapshots taken {taken[mode]} (only page-aligned "
                  f"prompt boundaries leave one), resident "
                  f"{sched._radix._n_snapshots}")
            tile_r = sum(r.plane_traffic_fraction for r in res) / len(res)
            check(0 < tile_r <= 1, f"mamba traffic fraction {tile_r}")
            combined = dict(combined_record(res, run), replay_tick_ms=rep)
    check(taken["cut/graph"] == taken["cut/eager"],
          f"mamba snapshots: {taken}")
    held_equal(f"mamba packed quant+stats, {CUT_LAYERS} layers",
               sruns["cut/graph"], sruns["cut/eager"])
    print(f"  at the first {CUT_LAYERS} of {cfg.n_layers} layers the graph "
          f"run equals its engine.eager() run in tokens, per-request stats, "
          f"forwards, snapshots and every tick's page table; decode step "
          f"{serve_out['scheduler/cut/eager']['step_ms']:.3f} ms eager -> "
          f"{serve_out['scheduler/cut/graph']['step_ms']:.3f} ms graph there "
          f"(host clock)")
    del sruns

    # -- three requests sharing a 64-token prefix: 2 snapshot hits --------
    gen = torch.Generator().manual_seed(11)
    prefix = torch.randint(0, cfg.vocab_size, (64,), generator=gen)
    hit_prompts = [torch.cat([prefix, torch.randint(
        0, cfg.vocab_size, (n,), generator=gen)]).numpy().astype("int32")
        for n in (5, 9, 13)]
    hit_toks = {}
    for cache in (True, False):
        sc = ServeConfig(**dict(SERVE, chunked="always", chunk_len=16,
                                prefix_cache=cache),
                         quant="pallas")
        sched = ServeScheduler(cfg, mb["pparams"], sc)
        sched.submit(hit_prompts[0], max_new=SERVE_NEW)
        sched.run()
        for p in hit_prompts[1:]:
            sched.submit(p, max_new=SERVE_NEW)
        res = sched.run()
        check(len(res) == 3 and all(len(r.tokens) == SERVE_NEW for r in res),
              f"prefix-hit run: "
              f"{[(r.finish_reason, len(r.tokens)) for r in res]}")
        hit_toks[cache] = [r.tokens for r in res]
        if cache:
            st = sched.prefix_cache_stats()
            check(st["lookup_hits"] == 2 and st["cached_tokens"] == 128,
                  f"prefix-hit run: {st}, expected 2 hits of 64 tokens")
    check(hit_toks[True] == hit_toks[False],
          "prefix-hit run: tokens differ from the same requests served "
          "without the prefix cache")
    print(f"  three requests sharing a 64-token prefix (chunked always, "
          f"chunk_len = page_len = 16, graphs): 2 lookups hit, 128 tokens "
          f"from shared pages and SSM snapshots; tokens equal the same "
          f"requests served without the prefix cache")
    print(f"  (phase 10 took {time.perf_counter() - t_phase:.0f} s)")
    return {"serve": serve_out, "combined": combined,
            "launches": runs["quant+stats"]["replayed"]["bitplane_matmul"]}


def quant_names(cfg) -> list:
    """The quantized projections of one forward, in call order: attention
    ``wq wk wv wo`` or mamba ``wz wx out_proj``, then a dense MLP's or the
    shared experts' ``gate up down``."""
    names = []
    for _ in range(cfg.repeats):
        for kind in cfg.pattern:
            attn = kind.split("_")[0] == "attn"
            names += PROJ[:4] if attn else MAMBA_PROJ
            if kind.endswith("_moe"):
                if cfg.n_shared_experts:
                    names += [f"shared {p}" for p in PROJ[4:]]
            elif attn or cfg.d_ff:
                names += PROJ[4:]
    return names


def moe_decode_k2(torch, dev, cfg, pparams, prompt, bm_ops, label) -> dict:
    """One quantized prefill of ``prompt`` and one decode step on packed
    planes; every K2 call of the step recorded with its real activations,
    its codes held against K1's plain version and its output against K2's
    (on the planes unpacked).  Returns the step's calls on unpacked planes
    (``k2_decode_step``'s input) and the capture."""
    from repro_torch.core.logquant import LogQuantized, log2_quantize
    from repro_torch.core.shiftadd import QuantCtx, shiftadd_matmul_bitplane
    from repro_torch.models.model import init_caches
    from repro_torch.serving import engine

    names = quant_names(cfg)
    caches = init_caches(cfg, BATCH, PROMPT + 1, device=dev)
    logits, caches = engine.make_prefill_step(cfg, True)(
        pparams, {"tokens": prompt}, caches)
    ctx = QuantCtx(capture=[])
    calls = recorded(bm_ops, lambda: engine.make_serve_step(cfg, ctx)(
        pparams, caches, torch.argmax(logits, -1).to(torch.int32)[:, None]))
    step_logits, _ = calls.result
    check(len(calls) == len(ctx.capture) == len(names),
          f"{label}: {len(calls)} K2 calls in a decode step, expected "
          f"{len(names)}")
    check(bool(torch.isfinite(logits.float()).all()
               and torch.isfinite(step_logits.float()).all()),
          f"{label}: non-finite logits")
    for i, (xs, exp, sign, planes, y) in enumerate(ctx.capture):
        what = f"{label} call {i} ({names[i]})"
        ref = log2_quantize(xs)
        check(torch.equal(exp, ref.exp) and torch.equal(sign, ref.sign),
              f"K2's codes differ from K1's plain version on {what}")
        check(torch.equal(y, shiftadd_matmul_bitplane(
            LogQuantized(exp, sign), planes)),
            f"K2 differs from its plain version on {what}")
    torch.cuda.synchronize()
    print(f"  {label}: one decode step's {len(calls)} K2 launches (M = "
          f"{BATCH}, packed planes) bit-equal to K1's and K2's plain "
          f"versions on their real activations")
    step_calls = [(x, a, cap[3], nb)
                  for (x, a, _, nb), cap in zip(calls, ctx.capture)]
    return {"step_calls": step_calls, "capture": ctx.capture}


def moe_step_bytes(cfg, batch: int, kv_len: int,
                   tile_fraction: float) -> dict:
    """Bytes one decode step of ``batch`` rows at ``kv_len`` cached tokens
    moves on an attention + MoE model, from its shapes: each weight or
    plane read once (the routed experts all, as the local formulation
    multiplies every expert's buffer), the KV cache read and one row
    written.  ``planes_read_packed`` scales the packed planes by the
    step's tile-granular traffic fraction."""
    d, el, layers = cfg.d_model, 2, cfg.n_layers
    e, ffe = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    shared = 3 * d * ffe * cfg.n_shared_experts
    qproj = attn + shared
    kv_row = 2 * hkv * hd * el
    out = {
        "routed_experts": layers * e * 3 * d * ffe * el,
        "float_projections": layers * qproj * el,
        "planes_packed": layers * qproj,
        "planes_read_packed": layers * qproj * tile_fraction,
        "router_norms": layers * (d * e * 4 + 2 * d * el) + d * el,
        "lm_head": cfg.vocab_size * d * el,
        "kv": batch * layers * (kv_len + 1) * kv_row,
    }
    rest = (out["routed_experts"] + out["router_norms"] + out["lm_head"]
            + out["kv"])
    out["step_float"] = out["float_projections"] + rest
    out["step_packed"] = out["planes_packed"] + rest
    out["qeihan_share_packed"] = out["planes_packed"] / out["step_packed"]
    out["routed_share_packed"] = out["routed_experts"] / out["step_packed"]
    return out


def phase11(torch, dev, card, l2_ops, bm_ops, pa_ops) -> dict:
    """deepseek-moe-16b at full width and depth, then one period of
    jamba-v0.1-52b at published width, then the three MoE smoke configs
    against the host; each model's memory is freed before the next."""
    t_phase = time.perf_counter()
    kernels = (l2_ops.log2quant, bm_ops.bitplane_matmul,
               pa_ops.paged_attention, pa_ops.paged_attention_quant)
    out = deepseek_full(torch, dev, card, kernels, bm_ops, pa_ops)
    gc_cuda(torch)
    out["jamba"] = jamba_period(torch, dev, card, kernels, bm_ops)
    gc_cuda(torch)
    for name in ("deepseek-moe-16b", "jamba-v0.1-52b", "phi3.5-moe-42b"):
        smoke_on_card(torch, dev, name)
    print(f"  (phase 11 took {time.perf_counter() - t_phase:.0f} s)")
    return out


def deepseek_full(torch, dev, card, kernels, bm_ops, pa_ops) -> dict:
    """deepseek-moe-16b at full width and depth: one-shot float and packed
    with stats, one decode step's graph, the bytes a step moves, K2 on a
    step's real activations and the routed-expert products, the scheduler
    with K3 and the expert-capacity drops of its ticks."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import init_params, param_count
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

    t_phase = time.perf_counter()
    cfg = get_config("deepseek-moe-16b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    pparams = quantize_model_params(cfg, params, pack=True)
    torch.cuda.synchronize()
    per_fwd = len(quant_names(cfg))
    check(per_fwd == cfg.n_layers * len(PROJ), f"deepseek: {per_fwd} "
          f"quantized projections a forward")
    pc = param_count(cfg)
    print(f"phase 11: {cfg.name} full width and depth, {cfg.n_layers}L "
          f"d={cfg.d_model} {cfg.n_heads}H/{cfg.n_kv_heads}kv x "
          f"{cfg.head_dim}, {cfg.n_experts} routed experts top-"
          f"{cfg.experts_per_token} (ffe {cfg.moe_d_ff}) + "
          f"{cfg.n_shared_experts} shared, vocab {cfg.vocab_size}, untied, "
          f"{cfg.dtype}, seed 0: {pc['total'] / 1e9:.3f} B parameters "
          f"({pc['active'] / 1e9:.3f} B active), built and quantized on "
          f"packed planes in {time.perf_counter() - t_phase:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; on "
          f"{card}")

    # -- one-shot: float, packed planes with stats; graph and eager -------
    runs = one_shot(torch, dev, cfg, prompt, (
        ("float", params, False, False),
        ("packed+stats", pparams, True, True)), kernels, per_fwd, "deepseek",
        cut=True)
    tile = runs["packed+stats"]["stats"]["plane_traffic_fraction"].cpu()
    elem = runs["packed+stats"]["stats"]["element_traffic_fraction"].cpu()
    check(bool((tile[:-1] > 0).all() and (tile[:-1] <= 1).all()
               and (elem[:-1] > 0).all() and (elem <= tile + 1e-6).all()
               and tile[-1] == 0), f"deepseek: bad traffic stats {tile} "
          f"{elem}")
    print(f"  K2 = {cfg.n_layers} layers x (wq wk wv wo + shared gate up "
          f"down) x {NEW} forwards = {per_fwd * NEW} launches per quantized "
          f"run, by census x replays and by the wrappers in the eager run; "
          f"K1 0; plane traffic per decode step: tile "
          f"{float(tile[:-1].mean()):.6f}, element "
          f"{float(elem[:-1].mean()):.6f}")
    steps = step_programs(torch, dev, cfg, prompt, (
        ("float", params, False), ("packed", pparams, True)), per_fwd)

    # -- bytes per decode step at batch 4, beside the measured step -------
    sb = moe_step_bytes(cfg, BATCH, PROMPT + NEW // 2,
                        float(tile[:-1].mean()))
    floor_ms = sb["routed_experts"] / HBM_BYTES_PER_S * 1e3
    print(f"  bytes per decode step at batch {BATCH} (from the shapes, KV "
          f"at {PROMPT + NEW // 2} tokens): routed experts "
          f"{sb['routed_experts'] / 1e9:.4f} GB (the local formulation "
          f"multiplies every expert's capacity buffer: {floor_ms:.3f} ms at "
          f"3.35 TB/s), attention + shared-expert planes packed "
          f"{sb['planes_packed'] / 1e9:.4f} GB (read by the skip rule "
          f"{sb['planes_read_packed'] / 1e9:.4f}; float "
          f"{sb['float_projections'] / 1e9:.4f}), lm head "
          f"{sb['lm_head'] / 1e9:.4f} GB, router and norms "
          f"{sb['router_norms'] / 1e9:.4f} GB, KV {sb['kv'] / 1e9:.4f} GB: "
          f"a packed step {sb['step_packed'] / 1e9:.4f} GB "
          f"({sb['step_packed'] / HBM_BYTES_PER_S * 1e3:.3f} ms), of which "
          f"QeiHaN's planes {sb['qeihan_share_packed']:.4f} and the routed "
          f"experts {sb['routed_share_packed']:.4f}; a float step "
          f"{sb['step_float'] / 1e9:.4f} GB; measured "
          f"{steps['packed']['replay_ms']:.4f} ms packed, "
          f"{steps['float']['replay_ms']:.4f} ms float (device, {card})")

    # -- K2 on one decode step's real activations; the routed products ----
    k2t = deepseek_step_kernels(torch, dev, cfg, params, pparams, prompt,
                                bm_ops, floor_ms)
    gc_cuda(torch)

    # -- the scheduler: phase 7's trace, K3, packed planes with stats -----
    trace = serve_trace(cfg.vocab_size)
    best, on_tick = most_pages(torch, dev)
    # the eager run counts each routed call's slots over capacity
    drops, dropped = [], []
    tables = moe._dispatch_tables

    def counting(ids, n_experts, capacity):
        order, dest, keep = tables(ids, n_experts, capacity)
        dropped.append((~keep).sum())
        return order, dest, keep

    def count_drops(sched):
        drops.append(int(sum(dropped)))
        dropped.clear()

    # the model's first SCHED_LAYERS layers as graphs (the measured path),
    # then its first CUT_LAYERS layers as graphs and under engine.eager(),
    # held equal
    scfg, sparams = first_layers(cfg, pparams, SCHED_LAYERS[cfg.name])
    ccfg, cparams = first_layers(cfg, pparams, CUT_LAYERS)
    plan = (("graph", scfg, sparams), ("cut/graph", ccfg, cparams),
            ("cut/eager", ccfg, cparams))
    sruns = {}
    for mode, c, p in plan:
        eager = mode.endswith("eager")
        if eager:
            moe._dispatch_tables = counting
        try:
            with engine.eager() if eager else contextlib.nullcontext():
                sruns[mode] = serve(
                    torch, dev, c, trace, quant=True, kernel=True,
                    stats=True, counters=kernels, params=p,
                    on_tick=(on_tick if mode == "graph" else
                             count_drops if eager else None))
        finally:
            moe._dispatch_tables = tables
    serve_out = {"one_shot": {tag: {
        "graph_tok_s": BATCH * NEW / r["t_graph"],
        "eager_tok_s": BATCH * NEW / r["t_eager"],
        "capture_ms": r["capture_ms"], "nodes": r["nodes"]}
        for tag, r in runs.items()}, "decode_step": steps,
        "step_bytes": sb}
    out = {"serve": serve_out, "k2": k2t,
           "k2_launches": runs["packed+stats"]["replayed"]["bitplane_matmul"]}
    for mode, c, _ in plan:
        res, sched, fwd, wall, run = sruns[mode]
        launches = (run["replayed"] if mode.endswith("graph") else
                    {k.__name__: k.launches for k in kernels})
        n_fwd = sum(fwd.values())
        k2_fwd = c.n_layers * len(PROJ)
        check(launches["bitplane_matmul"] == k2_fwd * n_fwd
              and launches["paged_attention"] == c.n_layers * fwd["decode"]
              and launches["log2quant"] == 0
              and launches["paged_attention_quant"] == 0,
              f"deepseek scheduler {mode}: launches {launches}, expected K2 "
              f"{k2_fwd} x {n_fwd} forwards, K3 {c.n_layers} x "
              f"{fwd['decode']} decode forwards, no K1 or K4")
        print(f"  scheduler K3 packed+stats, {mode} ({c.n_layers} layers): "
              f"forwards {fwd}; launches {launches}")
        serve_out[f"scheduler/{mode}"] = tok_s(
            f"deepseek packed+stats {mode} ({c.n_layers} layers)", res, wall,
            run, sched)
        if mode == "graph":
            out["k3_launches"] = launches["paged_attention"]
            program_report(sched, "deepseek packed+stats graph")
            rep = tick_replay_ms(torch, sched)
            (tick,) = sched.programs()["tick"].entries()
            nodes = engine.graph_nodes(tick)
            per_step = rep / sched.tick_steps
            serve_out["scheduler/graph"].update(
                replay_step_ms=per_step,
                nodes_per_step=(nodes[0] / sched.tick_steps if nodes
                                else None),
                compile_stats=sched.compile_stats())
            st = sched.prefix_cache_stats()
            print(f"    tick graph replayed alone: {rep:.3f} ms device time "
                  f"= {per_step:.3f} ms per decode step of "
                  f"{sched.max_slots} slots (CUDA events, {card}); "
                  + (f"{nodes[0] / sched.tick_steps:.0f} kernel nodes per "
                     f"step; " if nodes else "")
                  + f"host ms per decode step "
                  f"{serve_out['scheduler/graph']['step_ms']:.3f}; prefix "
                  f"cache hit_rate {st['hit_rate']:.6f}")
            tile_r = sum(r.plane_traffic_fraction for r in res) / len(res)
            check(0 < tile_r <= 1, f"deepseek traffic fraction {tile_r}")
    held_equal(f"deepseek packed+stats, {CUT_LAYERS} layers",
               sruns["cut/graph"], sruns["cut/eager"])
    del sruns
    worst = max(range(len(drops)), key=drops.__getitem__)
    check(drops[worst] > 0, "deepseek: no tick dropped a routed slot")
    cap8 = min(int(SERVE["max_slots"] * cfg.experts_per_token
                   / cfg.n_experts * cfg.capacity_factor) + 1,
               SERVE["max_slots"])
    serve_out["dropped_slots"] = {"max_tick": drops[worst],
                                  "total": sum(drops),
                                  "ticks_with_drops": sum(d > 0
                                                          for d in drops),
                                  "ticks": len(drops),
                                  "layers": CUT_LAYERS}
    serve_out["dropped_slots"]["last_tick"] = drops[-1]
    print(f"  at the first {CUT_LAYERS} of {cfg.n_layers} layers the graph "
          f"run equals its engine.eager() run in tokens, per-request stats, "
          f"forwards and every tick's page table; expert capacity drops "
          f"(that eager run, routed slots over capacity, summed over a "
          f"tick's forwards and {CUT_LAYERS} layers): tick {worst} dropped "
          f"{drops[worst]}, the last tick (decode only) {drops[-1]}; "
          f"{serve_out['dropped_slots']['ticks_with_drops']} of "
          f"{len(drops)} ticks dropped, {sum(drops)} in all (a decode "
          f"forward of {SERVE['max_slots']} slots admits {cap8} slot a "
          f"expert)")
    out["k3"] = k3_tick(torch, dev, card, cfg, pa_ops, best)
    print(f"  (deepseek-moe-16b took {time.perf_counter() - t_phase:.0f} s)")
    return out


def deepseek_step_kernels(torch, dev, cfg, params, pparams, prompt, bm_ops,
                          floor_ms) -> dict:
    """K2 on one decode step's real activations (``moe_decode_k2``) by
    CUDA-graph replay on both plane layouts, beside its bound, its plain
    version and the bf16 ``torch.matmul`` of the same shapes; the
    routed-expert products of one step beside their byte bound."""
    from repro_torch.models import moe

    gen = torch.Generator(device=dev).manual_seed(3)
    k2in = moe_decode_k2(torch, dev, cfg, pparams, prompt, bm_ops,
                         "deepseek")
    layouts, k2_step, plain_step, _, bounds = k2_decode_step(
        torch, bm_ops, k2in["step_calls"], k2in["capture"])
    blk = params["blocks"][0]
    weights = [blk[p] for p in PROJ[:4]] + [blk["mlp"]["shared"][p]
                                            for p in PROJ[4:]]
    acts = [torch.randn((BATCH, w.shape[1]), generator=gen, device=dev,
                        dtype=torch.bfloat16) for w in weights]

    def matmul_step():
        for r in range(cfg.n_layers):
            for a, w in zip(acts, weights):
                torch.matmul(a, w[r])

    experts = blk["mlp"]["experts"]
    cap = min(int(BATCH * cfg.experts_per_token / cfg.n_experts
                  * cfg.capacity_factor) + 1, BATCH)
    buf = torch.randn((cfg.n_experts, cap, cfg.d_model), generator=gen,
                      device=dev, dtype=cfg.dtype)

    def routed_step():
        for r in range(cfg.n_layers):
            moe._expert_ffn(buf, {k: v[r] for k, v in experts.items()},
                            cfg.dtype)

    n_calls = len(k2in["step_calls"])
    ms = {lay: graph_ms(torch, k2_step(lay)) for lay in layouts}
    k2t = {"ms": ms["unpacked"], "ms_packed": ms["packed"],
           "plain_ms": graph_ms(torch, plain_step),
           "bound_ms": bounds["unpacked"][0],
           "bound_by": bounds["unpacked"][1],
           "bound_ms_packed": bounds["packed"][0],
           "bound_by_packed": bounds["packed"][1], "library_ms": None,
           "context_matmul_ms": graph_ms(torch, matmul_step),
           "routed_ms": graph_ms(torch, routed_step, reps=5),
           "routed_bound_ms": floor_ms,
           "scope": f"one deepseek-moe-16b decode step: {n_calls} launches "
                    f"({cfg.n_layers} layers x wq wk wv wo + shared gate up "
                    f"down), M={BATCH}"}
    print(f"  K2 on that step, CUDA-graph replay: unpacked "
          f"{k2t['ms']:.4f} ms (bound {k2t['bound_ms']:.5f}, "
          f"{k2t['bound_by']}), packed {k2t['ms_packed']:.4f} ms (bound "
          f"{k2t['bound_ms_packed']:.5f}, {k2t['bound_by_packed']}); plain "
          f"version {k2t['plain_ms']:.4f} ms; context: bf16 torch.matmul of "
          f"the same {n_calls} shapes {k2t['context_matmul_ms']:.4f} ms")
    print(f"  routed-expert products of one decode step ({cfg.n_layers} "
          f"layers x {cfg.n_experts} experts x capacity {cap}, gate, up, "
          f"silu, down as torch.bmm): {k2t['routed_ms']:.4f} ms against "
          f"their byte bound {floor_ms:.4f} ms")
    return k2t


def first_layers(cfg, params, n: int):
    """``cfg`` cut to its first ``n`` layers (whole periods) and views of
    ``params``' stacked leaves to match (no copy): the depth at which
    phases 10, 11 and 12 hold their scheduler's graphs against eager
    runs."""
    cut = cfg.replace(n_layers=n)
    r = cut.repeats

    def view(tree):
        if isinstance(tree, dict):
            return {k: view(v) for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(None if t is None else t[:r] for t in tree))
        return tree[:r]

    return cut, dict(params, blocks=tuple(view(b) for b in params["blocks"]))


def gc_cuda(torch) -> None:
    """Free what the dropped references held on the card (the one-shot
    programs' graphs too)."""
    import gc

    from repro_torch.serving import engine

    engine.clear_generate_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def jamba_period(torch, dev, card, kernels, bm_ops) -> dict:
    """jamba-v0.1-52b at published width, cut to one 8-layer period of its
    32 layers: one-shot float and packed (graph and eager equal), and one
    decode step's K2 calls held against the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count
    from repro_torch.models.quantize import quantize_model_params

    t0 = time.perf_counter()
    full = get_config("jamba-v0.1-52b")
    cfg = full.replace(n_layers=len(full.pattern))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    pparams = quantize_model_params(cfg, params, pack=True)
    torch.cuda.synchronize()
    per_fwd = len(quant_names(cfg))
    pc = param_count(cfg)
    reduced = {"n_layers": [full.n_layers, cfg.n_layers]}
    print(f"  jamba: {cfg.name} at published width (d {cfg.d_model}, "
          f"{cfg.n_heads}H/{cfg.n_kv_heads}kv, {cfg.ssm_heads} SSD heads x "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, {cfg.n_experts} "
          f"experts top-{cfg.experts_per_token} ffe {cfg.moe_d_ff}, vocab "
          f"{cfg.vocab_size}), reduced {reduced} (one period: "
          f"{cfg.pattern}): {pc['total'] / 1e9:.3f} B parameters, built "
          f"and quantized on packed planes in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    runs = one_shot(torch, dev, cfg, prompt, (
        ("float", params, False, False), ("packed", pparams, True, False)),
        kernels, per_fwd, "jamba")
    moe_decode_k2(torch, dev, cfg, pparams, prompt, bm_ops, "jamba")
    out = {"reduced": reduced, "k2_launches": runs["packed"]["replayed"][
        "bitplane_matmul"], "one_shot": {tag: {
            "graph_tok_s": BATCH * NEW / r["t_graph"],
            "eager_tok_s": BATCH * NEW / r["t_eager"],
            "capture_ms": r["capture_ms"]} for tag, r in runs.items()}}
    return out


def dense_step_bytes(cfg, batch: int, kv_len: int,
                     tile_fraction: float) -> dict:
    """Bytes one decode step of ``batch`` rows at ``kv_len`` cached tokens
    moves on a dense attention model, from its shapes: each projection
    weight (bf16) or packed plane byte read once, ``lm_head``, the norms,
    the KV cache read and one row written.  ``planes_read_packed`` scales
    the packed planes by the step's tile-granular traffic fraction."""
    d, el, layers = cfg.d_model, 2, cfg.n_layers
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qproj = d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * cfg.d_ff
    out = {
        "float_projections": layers * qproj * el,
        "planes_packed": layers * qproj,
        "planes_read_packed": layers * qproj * tile_fraction,
        "norms": layers * (2 * d + 2 * hd) * el + d * el,
        "lm_head": cfg.vocab_size * d * el,
        "kv": batch * layers * (kv_len + 1) * 2 * hkv * hd * el,
    }
    rest = out["norms"] + out["lm_head"] + out["kv"]
    out["step_float"] = out["float_projections"] + rest
    out["step_packed"] = out["planes_packed"] + rest
    out["qeihan_share_packed"] = out["planes_packed"] / out["step_packed"]
    for key in ("step_float", "step_packed"):
        out[key.replace("step", "bound_ms")] = (out[key] / HBM_BYTES_PER_S
                                                * 1e3)
    return out


def phase12(torch, dev, card, l2_ops, bm_ops, pa_ops) -> dict:
    """qwen3-32b at full width and depth: one-shot and one decode step in
    float; every program dropped, then quantized on packed planes in
    place with ``drop_float``; one-shot packed with stats and one decode
    step packed; K2 on a decode step's real activations; the scheduler
    with K3.  Then the other new smoke configs against the host."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count
    from repro_torch.models.quantize import quantize_model_params

    t_phase = time.perf_counter()
    kernels = (l2_ops.log2quant, bm_ops.bitplane_matmul,
               pa_ops.paged_attention, pa_ops.paged_attention_quant)
    cfg = get_config("qwen3-32b")
    gc_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    gb = 1e9
    mem = {"init_peak_gb": torch.cuda.max_memory_allocated() / gb,
           "float_gb": torch.cuda.memory_allocated() / gb}
    names = quant_names(cfg)
    per_fwd = len(names)
    check(per_fwd == cfg.n_layers * len(PROJ), f"qwen3: {per_fwd} quantized "
          f"projections a forward")
    pc = param_count(cfg)
    print(f"phase 12: {cfg.name} full width and depth, {cfg.n_layers}L "
          f"d={cfg.d_model} {cfg.n_heads}H/{cfg.n_kv_heads}kv x "
          f"{cfg.head_dim}, ff {cfg.d_ff}, vocab {cfg.vocab_size}, untied, "
          f"qk_norm, {cfg.dtype}, seed 0: {pc['total'] / 1e9:.3f} B "
          f"parameters, built in {time.perf_counter() - t_phase:.1f} s, "
          f"{mem['float_gb']:.2f} GB on the card (peak "
          f"{mem['init_peak_gb']:.2f}); on {card}")

    # -- float: one-shot, one decode step, the matmul context -------------
    runs = one_shot(torch, dev, cfg, prompt, (
        ("float", params, False, False),), kernels, per_fwd, "qwen3",
        cut=True)
    steps = step_programs(torch, dev, cfg, prompt, (
        ("float", params, False),), per_fwd)
    blk = params["blocks"][0]
    weights = [blk[p] for p in PROJ[:4]] + [blk["mlp"][p] for p in PROJ[4:]]
    acts = [torch.randn((BATCH, w.shape[1]), device=dev,
                        dtype=torch.bfloat16) for w in weights]

    def matmul_step():
        for r in range(cfg.n_layers):
            for a, w in zip(acts, weights):
                torch.matmul(a, w[r])

    context_ms = graph_ms(torch, matmul_step, reps=5)
    del blk, weights, acts
    mem["float_runs_peak_gb"] = torch.cuda.max_memory_allocated() / gb

    # -- drop every program that holds the float leaves, then quantize in
    # place: each float leaf is freed as soon as its planes exist -------
    gc_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pparams = quantize_model_params(cfg, params, pack=True, drop_float=True)
    torch.cuda.synchronize()
    mem["quantize_s"] = time.perf_counter() - t0
    mem["quantize_peak_gb"] = torch.cuda.max_memory_allocated() / gb
    gc_cuda(torch)
    mem["packed_gb"] = torch.cuda.memory_allocated() / gb
    for tree in (params, pparams):
        b0 = tree["blocks"][0]
        for leaf in [b0[p] for p in PROJ[:4]] + [b0["mlp"][p]
                                                 for p in PROJ[4:]]:
            check(tuple(leaf.shape) == (cfg.repeats, 1),
                  f"qwen3: a float projection survived drop_float: "
                  f"{tuple(leaf.shape)}")
    print(f"  memory: {mem['float_gb']:.2f} GB after the init (peak "
          f"{mem['init_peak_gb']:.2f}), float runs peak "
          f"{mem['float_runs_peak_gb']:.2f}; in-place drop_float "
          f"quantization on packed planes in {mem['quantize_s']:.1f} s, peak "
          f"{mem['quantize_peak_gb']:.2f} GB; {mem['packed_gb']:.2f} GB "
          f"resident after it (torch.cuda.max_memory_allocated)")

    # -- packed planes alone: one-shot with stats, one decode step ---------
    runs.update(one_shot(torch, dev, cfg, prompt, (
        ("packed+stats", pparams, True, True),), kernels, per_fwd, "qwen3",
        cut=True))
    tile = runs["packed+stats"]["stats"]["plane_traffic_fraction"].cpu()
    elem = runs["packed+stats"]["stats"]["element_traffic_fraction"].cpu()
    check(bool((tile[:-1] > 0).all() and (tile[:-1] <= 1).all()
               and (elem[:-1] > 0).all() and (elem <= tile + 1e-6).all()
               and tile[-1] == 0), f"qwen3: bad traffic stats {tile} {elem}")
    print(f"  K2 = {cfg.n_layers} layers x {len(PROJ)} projections x {NEW} "
          f"forwards = {per_fwd * NEW} launches per quantized run, by census "
          f"x replays and by the wrappers in the eager run; K1, K3, K4 0; "
          f"plane traffic per decode step: tile {float(tile[:-1].mean()):.6f}"
          f", element {float(elem[:-1].mean()):.6f}")
    steps.update(step_programs(torch, dev, cfg, prompt, (
        ("packed", pparams, True),), per_fwd))
    sb = dense_step_bytes(cfg, BATCH, PROMPT + NEW // 2,
                          float(tile[:-1].mean()))
    print(f"  bytes per decode step at batch {BATCH} (from the shapes, KV at "
          f"{PROMPT + NEW // 2} tokens): projections float "
          f"{sb['float_projections'] / 1e9:.4f} GB, packed planes "
          f"{sb['planes_packed'] / 1e9:.4f} GB (read by the skip rule "
          f"{sb['planes_read_packed'] / 1e9:.4f}), lm head "
          f"{sb['lm_head'] / 1e9:.4f} GB, norms {sb['norms'] / 1e9:.6f} GB, "
          f"KV {sb['kv'] / 1e9:.4f} GB: a float step "
          f"{sb['step_float'] / 1e9:.4f} GB (bound {sb['bound_ms_float']:.3f}"
          f" ms), a packed step {sb['step_packed'] / 1e9:.4f} GB (bound "
          f"{sb['bound_ms_packed']:.3f} ms), QeiHaN's planes "
          f"{sb['qeihan_share_packed']:.4f} of it; measured "
          f"{steps['float']['replay_ms']:.4f} ms float, "
          f"{steps['packed']['replay_ms']:.4f} ms packed (device, {card}); "
          f"bf16 torch.matmul of the step's 448 projections alone "
          f"{context_ms:.4f} ms")

    # -- K2 on one decode step's real activations --------------------------
    k2t = qwen3_step_k2(torch, dev, cfg, pparams, prompt, bm_ops, names)
    k2t["context_matmul_ms"] = context_ms
    gc_cuda(torch)

    # -- the scheduler: phase 7's trace, K3, packed planes with stats -----
    sched_out, k3 = qwen3_scheduler(torch, dev, card, cfg, pparams, kernels,
                                    pa_ops)
    serve_out = {"one_shot": {tag: {
        "graph_tok_s": BATCH * NEW / r["t_graph"],
        "eager_tok_s": BATCH * NEW / r["t_eager"],
        "capture_ms": r["capture_ms"], "nodes": r["nodes"]}
        for tag, r in runs.items()}, "decode_step": steps,
        "step_bytes": sb, "memory": mem, **sched_out}
    out = {"serve": serve_out, "k2": k2t, "k3": k3,
           "k2_launches": runs["packed+stats"]["replayed"]["bitplane_matmul"],
           "k3_launches": sched_out["k3_launches"]}
    del pparams, params
    gc_cuda(torch)

    # -- the other new configurations' smoke configs against the host -----
    for name in ("qwen3-32b", "qwen2.5-14b", "phi4-mini-3.8b"):
        smoke_on_card(torch, dev, name)
    stubs_on_card(torch, dev)
    print(f"  (phase 12 took {time.perf_counter() - t_phase:.0f} s)")
    return out


def qwen3_step_k2(torch, dev, cfg, pparams, prompt, bm_ops, names) -> dict:
    """One quantized prefill and one decode step on packed planes: every
    K2 call of the step held, as it runs, against K1's and K2's plain
    versions on its real activations (the planes unpacked one call at a
    time: unpacked, the step's 448 would take 250 GB); then the step's
    launches on their recorded inputs timed by CUDA-graph replay beside
    their bound and the plain version."""
    from repro_torch.models.model import init_caches
    from repro_torch.serving import engine

    caches = init_caches(cfg, BATCH, PROMPT + 1, device=dev)
    logits, caches = engine.make_prefill_step(cfg, True)(
        pparams, {"tokens": prompt}, caches)
    calls = []
    inner = bm_ops.log2_bitplane_matmul

    def held(x, act_scale, planes, n_bits=4, codes=False, **kw):
        y, q = inner(x, act_scale, planes, n_bits, codes=True, **kw)
        py, pq = bm_ops.log2_bitplane_matmul_plain(x, act_scale, planes,
                                                   n_bits)
        what = f"qwen3 call {len(calls)} ({names[len(calls) % len(names)]})"
        check(torch.equal(q.exp, pq.exp) and torch.equal(q.sign, pq.sign),
              f"K2's codes differ from K1's plain version on {what}")
        check(torch.equal(y, py), f"K2 differs from its plain version on "
              f"{what}")
        calls.append((x.clone(), act_scale, planes, n_bits, q.exp))
        return (y, q) if codes else y

    bm_ops.log2_bitplane_matmul = held
    try:
        step_logits, _ = engine.make_serve_step(cfg, True)(
            pparams, caches, torch.argmax(logits, -1).to(torch.int32)[:, None])
    finally:
        bm_ops.log2_bitplane_matmul = inner
    check(len(calls) == len(names), f"qwen3: {len(calls)} K2 calls in a "
          f"decode step, expected {len(names)}")
    check(bool(torch.isfinite(logits.float()).all()
               and torch.isfinite(step_logits.float()).all()),
          "qwen3: non-finite logits")
    torch.cuda.synchronize()
    print(f"  qwen3: one decode step's {len(calls)} K2 launches (M = {BATCH}"
          f", packed planes) bit-equal to K1's and K2's plain versions on "
          f"their real activations")

    def k2_step():
        for x, a, planes, nb, _ in calls:
            bm_ops.log2_bitplane_matmul(x, a, planes, nb)

    def plain_step():
        for x, a, planes, nb, _ in calls:
            bm_ops.log2_bitplane_matmul_plain(x, a, planes, nb)

    nbytes = nops = 0.0
    for x, _, planes, _, exp in calls:
        b, _ = k2_bound(torch, bm_ops, exp, planes.shape[2], True,
                        x.element_size())
        nbytes += b
        nops += 2 * x.shape[0] * x.shape[1] * planes.shape[2]
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
    k2t = {"ms": graph_ms(torch, k2_step), "plain_ms": eager_ms(
        torch, plain_step, reps=1, warm=False), "bound_ms": max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": None, "bound_bytes": nbytes,
        "scope": f"one qwen3-32b decode step: {len(calls)} launches "
                 f"({cfg.n_layers} layers x wq wk wv wo gate up down), "
                 f"M={BATCH}, packed planes"}
    print(f"  K2 on that step, packed planes, CUDA-graph replay: "
          f"{k2t['ms']:.4f} ms against its bound {k2t['bound_ms']:.4f} ms "
          f"({k2t['bound_by']}: {nbytes / 1e9:.4f} GB of the tiles the skip "
          f"rule reads, x and the outputs); plain version "
          f"{k2t['plain_ms']:.4f} ms")
    return k2t


def qwen3_scheduler(torch, dev, card, cfg, pparams, kernels, pa_ops):
    """Phase 7's trace and ``ServeConfig`` with K3 on packed planes with
    stats, as graphs at the model's first ``SCHED_LAYERS`` layers (tok/s,
    ms a step, nodes, ``compile_stats()``, K3 on the tick touching most
    pages, timed over all 64 layers' launches); then the model's first
    ``CUT_LAYERS`` layers over the same trace as graphs and under
    ``engine.eager()``, held equal (the eager run of the whole trace would
    take minutes at 64 layers)."""
    from repro_torch.serving import engine

    trace = serve_trace(cfg.vocab_size)
    best, on_tick = most_pages(torch, dev)
    out = {}

    def launches_ok(label, c, run, fwd, mode):
        launches = (run["replayed"] if mode == "graph" else
                    {k.__name__: k.launches for k in kernels})
        n_fwd = sum(fwd.values())
        k2_fwd = c.n_layers * len(PROJ)
        check(launches["bitplane_matmul"] == k2_fwd * n_fwd
              and launches["paged_attention"] == c.n_layers * fwd["decode"]
              and launches["log2quant"] == 0
              and launches["paged_attention_quant"] == 0,
              f"{label}: launches {launches}, expected K2 {k2_fwd} x "
              f"{n_fwd} forwards, K3 {c.n_layers} x {fwd['decode']} decode "
              f"forwards, no K1 or K4")
        print(f"  {label}: forwards {fwd}; launches {launches}")
        return launches

    scfg, sparams = first_layers(cfg, pparams, SCHED_LAYERS[cfg.name])
    res, sched, fwd, wall, run = serve(
        torch, dev, scfg, trace, quant=True, kernel=True, stats=True,
        counters=kernels, params=sparams, on_tick=on_tick)
    launches = launches_ok(f"qwen3 scheduler K3 packed+stats, graph "
                           f"({scfg.n_layers} layers)", scfg, run, fwd,
                           "graph")
    out["k3_launches"] = launches["paged_attention"]
    out["scheduler/graph"] = tok_s("qwen3 packed+stats graph", res, wall,
                                   run, sched)
    program_report(sched, "qwen3 packed+stats graph")
    rep = tick_replay_ms(torch, sched)
    (tick,) = sched.programs()["tick"].entries()
    nodes = engine.graph_nodes(tick)
    per_step = rep / sched.tick_steps
    st = sched.prefix_cache_stats()
    out["scheduler/graph"].update(
        replay_step_ms=per_step, compile_stats=sched.compile_stats(),
        nodes_per_step=nodes[0] / sched.tick_steps if nodes else None,
        hit_rate=st["hit_rate"])
    print(f"    tick graph replayed alone: {rep:.3f} ms device time = "
          f"{per_step:.3f} ms per decode step of {sched.max_slots} slots "
          f"(CUDA events, {card}); "
          + (f"{nodes[0] / sched.tick_steps:.0f} kernel nodes per step; "
             if nodes else "")
          + f"host ms per decode step {out['scheduler/graph']['step_ms']:.3f}"
          f"; prefix cache hit_rate {st['hit_rate']:.6f}")
    tile_r = sum(r.plane_traffic_fraction for r in res) / len(res)
    check(0 < tile_r <= 1, f"qwen3 traffic fraction {tile_r}")
    del res, sched, run, tick
    gc_cuda(torch)
    k3 = k3_tick(torch, dev, card, cfg, pa_ops, best)
    del best
    gc_cuda(torch)

    # the model's first CUT_LAYERS layers over the same trace as graphs
    # and under engine.eager(), held equal
    ccfg, cparams = first_layers(cfg, pparams, CUT_LAYERS)
    sruns = {}
    for mode in ("graph", "eager"):
        with (engine.eager() if mode == "eager"
              else contextlib.nullcontext()):
            sruns[mode] = serve(torch, dev, ccfg, trace, quant=True,
                                kernel=True, stats=True, counters=kernels,
                                params=cparams)
        res, sched, fwd, wall, run = sruns[mode]
        launches_ok(f"qwen3 scheduler, {CUT_LAYERS} layers, {mode}", ccfg,
                    run, fwd, mode)
        out[f"scheduler/cut/{mode}"] = tok_s(
            f"qwen3 packed+stats {mode} ({CUT_LAYERS} layers)", res, wall,
            run, sched)
    held_equal(f"qwen3 packed+stats, {CUT_LAYERS} layers", sruns["graph"],
               sruns["eager"])
    print(f"  at the first {CUT_LAYERS} of {cfg.n_layers} layers the graph "
          f"run equals its engine.eager() run in tokens, per-request stats, "
          f"forwards and every tick's page table")
    del sruns
    gc_cuda(torch)
    return out, k3


def stubs_on_card(torch, dev) -> None:
    """The frontend stubs' smoke configs in f32 (weights from seed 5,
    quantized on unpacked planes) on the card against the plain path on
    the host: internvl2 through ``make_prefill_step`` over tokens and patch
    embeddings and ``make_decode_loop`` (a cache of n_image_tokens +
    prompt + new rows), musicgen frame by frame through
    ``make_serve_step``.  Float: tokens equal, logits within 1e-4.
    Quantized: every K2 call of the run, in order, takes the host's codes
    and gives its int32 output until the first call whose input crosses a
    LOG2 code boundary between the host's and the card's float rounding
    (cuBLAS and ATen's CPU kernels sum in other orders); such a call is
    allowed only where every differing code sits on an input that differs
    in its last bits, and the runs are not compared after it; without one,
    tokens equal and logits within 1e-4."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.shiftadd import QuantCtx
    from repro_torch.models.model import init_caches, init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

    for name in ("internvl2-26b", "musicgen-medium"):
        scfg = get_smoke(name).replace(dtype=torch.float32)
        sq_cpu = quantize_model_params(scfg, init_params(
            scfg, generator=torch.Generator().manual_seed(5), device="cpu"))
        sq_gpu = _to(torch, sq_cpu, dev)
        g = torch.Generator().manual_seed(6)
        toks = torch.randint(0, scfg.vocab_size, (2, 8), generator=g,
                             dtype=torch.int32)
        img = torch.randn((2, scfg.n_image_tokens, scfg.d_model),
                          generator=g)
        frames = torch.randn((8, 2, 1, scfg.d_model), generator=g)
        for quant in (False, True):
            got = []
            for p, d in ((sq_cpu, torch.device("cpu")), (sq_gpu, dev)):
                q = QuantCtx(capture=[]) if quant else False
                if scfg.frontend == "vision_stub":
                    caches = init_caches(scfg, 2, scfg.n_image_tokens + 16,
                                         device=d)
                    logits, caches = engine.make_prefill_step(scfg, q)(
                        p, {"tokens": toks.to(d), "image_embeds": img.to(d)},
                        caches)
                    out, _ = engine.make_decode_loop(scfg, 8, quant=q)(
                        p, caches, logits)
                else:
                    caches = init_caches(scfg, 2, 8, device=d)
                    step = engine.make_serve_step(scfg, q)
                    lg = []
                    for f in frames:
                        step_logits, caches = step(p, caches, f.to(d))
                        lg.append(step_logits)
                    logits = torch.stack(lg, 1)
                    out = torch.argmax(logits, -1)
                caps = [] if not quant else [
                    tuple(t.cpu() for t in c) for c in q.capture]
                got.append((out.cpu(), logits.cpu(), caps))
            (ta, la, ca), (tb, lb, cb) = got
            flip = first_flip(torch, ca, cb, f"{scfg.name} quantized")
            err = float((la - lb).abs().max())
            if flip is None:
                check(torch.equal(ta, tb) and err <= 1e-4,
                      f"{scfg.name} (quant={quant}) on the card differs from "
                      f"the host's plain path: tokens equal "
                      f"{torch.equal(ta, tb)}, logits max |diff| {err}")
                print(f"  {scfg.name} f32 (quant={quant}): tokens equal the "
                      f"host's plain path, logits max |diff| {err:.2e}" +
                      (f"; all {len(ca)} K2 calls took the host's codes and "
                       f"gave its outputs" if quant else ""))
            else:
                i, n, rel = flip
                print(f"  {scfg.name} f32 (quant=True): K2 calls 0..{i - 1} "
                      f"of {len(ca)} took the host's codes and gave its "
                      f"outputs; call {i}'s input crosses a LOG2 code "
                      f"boundary at {n} element(s) whose host and card "
                      f"values differ by float rounding (relative "
                      f"{rel:.1e}), so the runs part there (logits max "
                      f"|diff| {err:.2e}, tokens equal {torch.equal(ta, tb)})")


def first_flip(torch, ca, cb, label):
    """Walk two ``QuantCtx`` captures of one run (host, card) in call
    order: codes and int32 outputs equal until the first call whose codes
    differ; there every differing code must sit on an input that differs
    by float rounding alone (relative 1e-5).  Returns ``(call, codes,
    relative difference)`` of that call, or None."""
    check(len(ca) == len(cb), f"{label}: {len(ca)} K2 calls on the host, "
          f"{len(cb)} on the card")
    for i, (a, b) in enumerate(zip(ca, cb)):
        diff = (a[1] != b[1]) | (a[2] != b[2])
        if bool(diff.any()):
            xa, xb = a[0][diff], b[0][diff]
            rel = float(((xa - xb).abs() / xa.abs().clamp(min=1e-30)).max())
            check(bool((xa != xb).all()) and rel <= 1e-5,
                  f"{label} call {i}: codes differ on inputs that differ by "
                  f"{rel} (relative)")
            return i, int(diff.sum()), rel
        check(torch.equal(a[4], b[4]), f"{label} call {i}: equal codes, "
              f"different int32 outputs")
    return None


def _to(torch, tree, dev):
    """Move a params tree (dicts, tuples, QuantizedLinearParams, tensors)
    to dev."""
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = (None if v is None else _to(torch, v, dev) for v in tree)
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else tuple(items))
    return tree.to(dev)




def phase13(torch, dev, card, l2_ops, bm_ops, pa_ops) -> dict:
    """The paper's own evaluation at the published sizes: the five Table I
    nets record their GEMM inputs on the card, K1 codes every one, the
    codes feed ``measure`` and ``weight_access_report``, the same weights
    run through the plain path on the host, and the simulator turns the
    card's statistics into Figs. 2, 3 and 9-11."""
    import numpy as np

    from repro_torch.core.access_model import weight_access_report
    from repro_torch.core.logquant import LogQuantized, log2_quantize
    from repro_torch.models import paper_nets
    from repro_torch.simulator import (ALL_ACCELERATORS, PAPER_WORKLOADS,
                                       measure, paper_preset, simulate)

    t_phase = time.perf_counter()
    gc_cuda(torch)
    kernels = (l2_ops.log2quant, bm_ops.bitplane_matmul,
               pa_ops.paged_attention, pa_ops.paged_attention_quant)
    print(f"phase 13: the paper's five nets (Table I) at published sizes, "
          f"f32, weights from seed 13 + i on the card; on {card}")
    nets = {}
    card_stats = {}
    for i, name in enumerate(PAPER_NETS):
        fwd = paper_nets.PAPER_ACTIVATIONS[name]
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(13 + i)
        params = paper_nets.init_paper_params(name, gen, dev)
        fwd(params)                          # cuDNN's algorithm choice
        fwd_ms = eager_ms(torch, lambda: fwd(params), reps=3, warm=False)
        fwd_graph_ms = graph_ms(torch, lambda: fwd(params), reps=5)
        # the path: the forward, then K1 on every recorded tensor in one
        # list call, every count set to 0 just before and read just after
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        acts = fwd(params)
        xs = [a for _, a in acts]
        flat, codes = l2_ops.log2quant_many(xs)
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in kernels}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(counts == {"log2quant": PAPER_K1_LAUNCHES[name],
                         "bitplane_matmul": 0, "paged_attention": 0,
                         "paged_attention_quant": 0},
              f"phase 13 {name}: launches {counts}")
        names = [n for n, _ in acts]
        elems = sum(a.numel() for a in xs)
        # the old calling convention, one launch per tensor, as yardstick,
        # its launches counted
        torch.cuda.synchronize()
        l2_ops.log2quant.launches = 0
        single = [l2_ops.log2quant(a) for a in xs]
        per_tensor_launches = l2_ops.log2quant.launches
        check(per_tensor_launches == len(xs),
              f"phase 13 {name}: the per-tensor calls launched "
              f"{per_tensor_launches} times for {len(xs)} tensors")
        err = 0
        for n, a, q, q1 in zip(names, xs, codes, single):
            check(a.dtype == torch.float32 and bool(torch.isfinite(a).all()),
                  f"phase 13 {name} {n}: non-finite or not f32")
            ref = log2_quantize(a)
            err = max(err, int((q.exp.int() - ref.exp.int()).abs().max()),
                      int((q.sign.int() - ref.sign.int()).abs().max()))
            check(torch.equal(q.exp, ref.exp) and torch.equal(q.sign,
                                                              ref.sign),
                  f"phase 13 {name} {n}: K1 differs from its plain version")
            check(torch.equal(q.exp, q1.exp) and torch.equal(q.sign,
                                                             q1.sign),
                  f"phase 13 {name} {n}: the list call differs from the "
                  f"per-tensor call")
        k1_ms = graph_ms(torch, lambda: l2_ops.log2quant_many(xs),
                         inner=K1_INNER)
        single_ms = graph_ms(torch, lambda: [l2_ops.log2quant(a)
                                             for a in xs], inner=K1_INNER)
        one_call_ms = graph_ms(torch, lambda: l2_ops.log2quant_many(xs))
        plain_ms = graph_ms(torch, lambda: [log2_quantize(a) for a in xs],
                            reps=5)
        exp = flat.exp
        st = measure(LogQuantized(exp, torch.ones_like(exp)))
        cat = torch.cat([q.exp.reshape(-1) for q in single])
        st1 = measure(LogQuantized(cat, torch.ones_like(cat)))
        check(np.array_equal(st.hist, st1.hist)
              and st.zero_frac == st1.zero_frac,
              f"phase 13 {name}: measure of the flat codes differs from "
              f"measure of the per-tensor codes concatenated")
        card_stats[name] = st
        reports = [weight_access_report(q) for q in codes]
        sav_e = [float(r.savings_element) for r in reports]
        sav_t = [float(r.savings_tile) for r in reports]
        whole = weight_access_report(LogQuantized(exp, torch.ones_like(exp)))
        check(abs(float(whole.savings_element)
                  - st.estimated_memory_savings()) < 1e-5,
              f"phase 13 {name}: access report and measure disagree")

        # the same weights through the plain path on the host
        t0 = time.perf_counter()
        host = fwd({k: v.cpu() for k, v in params.items()})
        check([n for n, _ in host] == names, f"phase 13 {name}: host names")
        flips = signs = 0
        host_exp = []
        for (_, h), q in zip(host, codes):
            hq = log2_quantize(h)
            flips += int((hq.exp != q.exp.cpu()).sum())
            signs += int(((hq.exp == q.exp.cpu())
                          & (hq.sign != q.sign.cpu())).sum())
            host_exp.append(hq.exp.reshape(-1))
        host_exp = torch.cat(host_exp)
        hst = measure(LogQuantized(host_exp, torch.ones_like(host_exp)))
        host_s = time.perf_counter() - t0
        share = (flips + signs) / elems
        check(share < FLIP_LIMIT, f"phase 13 {name}: {share:.3g} of the codes "
              f"differ between the card and the host (limit {FLIP_LIMIT})")
        nbytes = elems * (4 + 2)
        nets[name] = dict(
            records=len(xs), elements=elems, max_abs_err=err,
            forward_ms=fwd_ms,
            forward_graph_ms=fwd_graph_ms, peak_gb=peak_gb,
            launches=counts["log2quant"], ms=k1_ms,
            ms_one_call=one_call_ms, per_tensor_ms=single_ms,
            per_tensor_launches=per_tensor_launches,
            plain_ms=plain_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes,
            flipped_codes=flips, flipped_signs=signs, flipped_share=share,
            d_negative_fraction=abs(st.negative_fraction
                                    - hst.negative_fraction),
            d_zero_frac=abs(st.zero_frac - hst.zero_frac), host_s=host_s,
            negative_fraction=st.negative_fraction, zero_frac=st.zero_frac,
            savings=st.estimated_memory_savings())
        r = nets[name]
        print(f"  {name}: {len(xs)} records, {elems} elements; forward "
              f"{fwd_ms:.4f} ms (host-issued, CUDA events) / "
              f"{fwd_graph_ms:.4f} ms (graph replay); peak "
              f"{peak_gb:.3f} GB; K1 list call {counts['log2quant']} "
              f"launch(es) {k1_ms:.4f} ms (graph replay, {K1_INNER} calls a"
              f" graph; one call a graph {one_call_ms:.4f}) against its "
              f"{r['bound_ms']:.5f} ms bound ({nbytes} B) = "
              f"{r['bound_ms'] / k1_ms:.3f} of it; one launch per tensor "
              f"({per_tensor_launches}, counted) {single_ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms; codes bit-equal to the plain version and"
              f" to the per-tensor calls, measure of the flat codes equal "
              f"to measure of their concatenation")
        print(f"    host (same weights, plain path): {host_s:.1f} s; codes "
              f"that differ {flips} exponents + {signs} signs of {elems} = "
              f"{share:.3g} (limit {FLIP_LIMIT}); |d negative_fraction| "
              f"{r['d_negative_fraction']:.3g}, |d zero_frac| "
              f"{r['d_zero_frac']:.3g}")
        print(f"    negative_fraction {st.negative_fraction:.6f}, zero_frac "
              f"{st.zero_frac:.6f}, estimated savings "
              f"{st.estimated_memory_savings():.6f}; weight_access_report "
              f"per layer: element savings {min(sav_e):.4f}..{max(sav_e):.4f}"
              f", tile (256) savings {min(sav_t):.4f}..{max(sav_t):.4f}")
        del params, acts, codes, xs, host, exp, host_exp, flat, single, cat
        gc_cuda(torch)

    # -- the simulator: Figs. 2, 3 and 9-11 --------------------------------
    figs = {}
    for source in ("card", "preset"):
        stats = card_stats if source == "card" else {
            m: paper_preset(m) for m in PAPER_NETS}
        sims = {m: {c.name: simulate(c, PAPER_WORKLOADS[m](), stats[m])
                    for c in ALL_ACCELERATORS} for m in PAPER_NETS}
        f = {"neg_frac": {m: stats[m].negative_fraction for m in PAPER_NETS},
             "fig3_avg_savings": float(sum(
                 stats[m].estimated_memory_savings() for m in PAPER_NETS)
                 / len(PAPER_NETS))}
        for fig, num, den, key in (
                ("fig9", "qeihan", "neurocube", "dram_bits"),
                ("fig9", "qeihan", "nahid", "dram_bits"),
                ("fig10", "neurocube", "qeihan", "time_s"),
                ("fig10", "nahid", "qeihan", "time_s"),
                ("fig11", "neurocube", "qeihan", "energy_j"),
                ("fig11", "nahid", "qeihan", "energy_j")):
            base = den if num == "qeihan" else num
            per = {m: getattr(s[num], key) / getattr(s[den], key)
                   for m, s in sims.items()}
            f[f"{fig}_vs_{base}"] = per
            f[f"{fig}_avg_vs_{base}"] = sum(per.values()) / len(per)
        for v in f.values():
            for x in (v.values() if isinstance(v, dict) else [v]):
                check(math.isfinite(x) and x > 0, f"phase 13: bad figure {f}")
        figs[source] = f
    print("  Fig. 2 negative-exponent share: card / preset / paper")
    for m in PAPER_NETS:
        print(f"    {m}: {figs['card']['neg_frac'][m]:.4f} / "
              f"{figs['preset']['neg_frac'][m]:.4f} / "
              f"{PAPER_VALUES['neg_frac'][m]}")
    for key in ("fig3_avg_savings", "fig9_avg_vs_neurocube",
                "fig9_avg_vs_nahid", "fig10_avg_vs_neurocube",
                "fig10_avg_vs_nahid", "fig11_avg_vs_neurocube",
                "fig11_avg_vs_nahid"):
        print(f"  {key}: card {figs['card'][key]:.4f}, preset "
              f"{figs['preset'][key]:.4f}, paper {PAPER_VALUES[key]}")
    for fig, paper in (("fig10_vs_nahid", {"ptblm": "fig10_ptblm_vs_nahid",
                                           "alexnet": "fig10_alexnet_vs_nahid"}),
                       ("fig11_vs_neurocube",
                        {"ptblm": "fig11_ptblm_vs_neurocube"}),
                       ("fig11_vs_nahid", {"ptblm": "fig11_ptblm_vs_nahid"})):
        print(f"  {fig} per net (card / preset / paper): " + ", ".join(
            f"{m} {figs['card'][fig][m]:.3f} / {figs['preset'][fig][m]:.3f}"
            + (f" / {PAPER_VALUES[paper[m]]}" if m in paper else "")
            for m in PAPER_NETS))
    total = {k: sum(r[k] for r in nets.values())
             for k in ("launches", "elements", "ms", "ms_one_call",
                       "per_tensor_ms", "per_tensor_launches", "plain_ms",
                       "bytes")}
    bound = total["bytes"] / HBM_BYTES_PER_S * 1e3
    check(total["launches"] == sum(PAPER_K1_LAUNCHES.values()),
          f"phase 13: K1 launched {total['launches']} times")
    print(f"  K1 on the paper path: {total['launches']} launches (one list "
          f"call a net), {total['elements']} elements, {total['ms']:.4f} ms "
          f"(graph replay, {K1_INNER} calls a graph, summed over the nets; "
          f"one call a graph "
          f"{total['ms_one_call']:.4f}) against its {bound:.5f} ms bound = "
          f"{bound / total['ms']:.3f} of it; one launch per tensor "
          f"({total['per_tensor_launches']} launches) "
          f"{total['per_tensor_ms']:.4f} ms in the same call; plain "
          f"{total['plain_ms']:.4f} ms; phase 13 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    print(f"paper evaluation ({card}): "
          f"{json.dumps({'nets': nets, 'figures': figs})}")
    return {"k1": {"launches": total["launches"], "ms": total["ms"],
                   "plain_ms": total["plain_ms"], "bound_ms": bound,
                   "bound_by": "bytes", "library_ms": None,
                   "ms_one_call": total["ms_one_call"],
                   "per_tensor_ms": total["per_tensor_ms"],
                   "per_tensor_launches": total["per_tensor_launches"],
                   "max_abs_err": max(r["max_abs_err"]
                                      for r in nets.values()),
                   "per_net": {m: {k: nets[m][k] for k in (
                       "launches", "ms", "ms_one_call",
                       "per_tensor_ms", "per_tensor_launches", "plain_ms",
                       "bound_ms")}
                       for m in PAPER_NETS}}}


def span_bytes(span) -> int:
    """A span's array bytes: prompt, logits row, pages, state."""
    return (span.prompt.nbytes + span.logits.nbytes
            + sum(a.nbytes for g in span.layers for a in g.values()))


def p50_p95(seconds) -> list:
    """The 50th and 95th percentiles of host times, in ms."""
    import numpy as np

    ms = np.asarray(seconds, dtype=float) * 1e3
    return [float(np.percentile(ms, 50)), float(np.percentile(ms, 95))]


def routed(torch, cfg, params, sc, trace, kernels) -> dict:
    """Serve ``trace`` through the in-process ``Router`` (CUDA graphs in
    both engines), every count set to 0 just before the run and read just
    after.  Each span's export and import are timed (host clock between
    two synchronisations, so the router's own run pays them), its bytes
    counted, and the first span's frame written, read and written again
    to the same bytes.  Returns results, router, wall seconds, launches
    (counted by the wrappers; replayed: census x replays over both
    engines' programs), each engine's forwards and the span records."""
    from repro_torch.serving import PageSpan, Router

    router = Router(cfg, params, sc)
    spans = {"bytes": [], "export_ms": [], "import_ms": []}

    def timed(fn, key):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spans[key].append((time.perf_counter() - t0) * 1e3)
            if key == "export_ms":
                if not spans["bytes"]:
                    blob = out.to_bytes()
                    check(PageSpan.from_bytes(blob).to_bytes() == blob,
                          "a span's frame does not read back to itself")
                spans["bytes"].append(span_bytes(out))
            return out
        return call

    router.prefill._export = timed(router.prefill._export, "export_ms")
    router.decode._import = timed(router.decode._import, "import_ms")
    live = []                           # the decode fleet's live slots
    step = router.decode.step

    def counted_step():
        live.append(router.decode.active)
        return step()

    router.decode.step = counted_step
    for p in trace:
        router.submit(p, max_new=SERVE_NEW)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = router.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = {k.__name__: k.launches for k in kernels}
    replayed, fwd = {k.__name__: 0 for k in kernels}, {}
    for role, eng in (("prefill", router.prefill), ("decode", router.decode)):
        progs = eng.scheduler.programs()
        for prog in progs.values():
            for k, n in prog.replayed_launches().items():
                replayed[k] = replayed.get(k, 0) + n
        ts = eng.scheduler.tick_steps
        fwd[role] = {
            "decode": ts * (progs["tick"].calls + progs["mixed"].calls),
            "chunk": progs["chunk"].calls + progs["mixed"].calls,
            "prefill": progs["prefill"].calls}
    check(fwd["prefill"]["decode"] == 0 and fwd["decode"]["chunk"]
          == fwd["decode"]["prefill"] == 0,
          f"an engine ran the other's work: forwards {fwd}")
    return dict(res=res, router=router, wall=wall, counted=counted,
                replayed=replayed, fwd=fwd, spans=spans, live=live,
                replay_tick_ms=tick_replay_ms(torch, router.decode.scheduler))


def same_as_combined(label, res, want) -> None:
    """Tokens, finish reasons and errors equal the combined run's."""
    got = [(r.tokens, r.finish_reason, r.error) for r in res]
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    first = None
    if diff:
        a, b = got[diff[0]][0], want[diff[0]][0]
        first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
    check(len(got) == len(want) and not diff,
          f"{label}: {len(got)} results, requests {diff} differ from the "
          f"combined scheduler's (request {diff[:1]}: first differing token "
          f"{first})")


def report_routed(label, r, combined, cfg, card) -> dict:
    """Print and return a routed run's numbers beside the combined run's
    tick times."""
    router, res, spans = r["router"], r["res"], r["spans"]
    total = sum(len(x.tokens) for x in res)
    # ticks that captured a graph are left out of the percentiles: the
    # decode engine captures its one tick program on its first tick
    check(router.decode.scheduler.compile_stats()["tick"] == 1,
          f"{label}: the decode engine built more than one tick graph")
    dec = p50_p95(router.decode_tick_times[1:])
    chunk = [dt for dt, c, cap, _ in combined["ticks"] if c and not cap]
    plain = [(dt, n) for dt, c, cap, n in combined["ticks"]
             if not c and not cap]
    captures = sum(cap for _, _, cap, _ in combined["ticks"])
    live = r["live"][1:]
    out = {"tok_s": total / r["wall"], "wall_s": r["wall"],
           "decode_tick_ms_p50_p95": dec,
           "decode_ticks": len(router.decode_tick_times),
           "decode_capture_tick_ms": router.decode_tick_times[0] * 1e3,
           "decode_live_slots_mean": sum(live) / len(live),
           "decode_replay_tick_ms": r["replay_tick_ms"],
           "combined_chunk_tick_ms_p50_p95": p50_p95(chunk),
           "combined_decode_tick_ms_p50_p95": p50_p95(
               [dt for dt, _ in plain]),
           "combined_decode_live_slots_mean": sum(
               n for _, n in plain) / len(plain),
           "combined_replay_tick_ms": combined["replay_tick_ms"],
           "combined_ticks": [len(chunk), len(plain)],
           "spans": len(spans["bytes"]), "span_bytes": sum(spans["bytes"]),
           "export_ms": spans["export_ms"], "import_ms": spans["import_ms"]}
    print(f"  {label} ({cfg.n_layers} layers): {len(res)} requests, "
          f"{total} tokens in {r['wall']:.3f} s = {out['tok_s']:.2f} tok/s "
          f"(captures, exports and imports included); forwards {r['fwd']}; "
          f"launches replayed {r['replayed']}, counted by the wrappers in "
          f"the warm-ups and captures {r['counted']}")
    print(f"    compile_stats prefill "
          f"{router.prefill.scheduler.compile_stats()}, decode "
          f"{router.decode.scheduler.compile_stats()}")
    print(f"    decode fleet: {out['decode_ticks']} ticks, the first "
          f"(capture) {out['decode_capture_tick_ms']:.1f} ms, the others "
          f"p50/p95 {dec[0]:.3f}/{dec[1]:.3f} ms; combined scheduler (host "
          f"clock around step_tick), {captures} ticks with a capture left "
          f"out: {len(chunk)} ticks with a chunk p50/p95 "
          f"{out['combined_chunk_tick_ms_p50_p95'][0]:.3f}/"
          f"{out['combined_chunk_tick_ms_p50_p95'][1]:.3f} ms, {len(plain)} "
          f"without p50/p95 {out['combined_decode_tick_ms_p50_p95'][0]:.3f}/"
          f"{out['combined_decode_tick_ms_p50_p95'][1]:.3f} ms ({card})")
    print(f"    live slots a tick, mean: decode fleet "
          f"{out['decode_live_slots_mean']:.2f}, combined ticks without a "
          f"chunk {out['combined_decode_live_slots_mean']:.2f}; the tick "
          f"graph replayed alone on the drained pool (CUDA events): decode "
          f"engine {r['replay_tick_ms']:.3f} ms, combined scheduler "
          f"{combined['replay_tick_ms']:.3f} ms")
    print(f"    spans: {out['spans']}, {out['span_bytes']} bytes in all "
          f"(min {min(spans['bytes'])}, max {max(spans['bytes'])}); export "
          f"ms {[round(x, 3) for x in spans['export_ms']]}; import ms "
          f"{[round(x, 3) for x in spans['import_ms']]}")
    return out


def phase14(torch, dev, card, l2_ops, bm_ops, pa_ops, combined) -> dict:
    """Disaggregated serving on the card: smollm-135m (float with K3, then
    packed planes with kv_quant and K4) and mamba2-780m through the
    in-process ``Router``, then smollm-135m across two spawned processes;
    every run's tokens equal the combined scheduler's (phases 7, 9 and 10
    for the in-process runs)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import ServeScheduler, run_disaggregated

    t_phase = time.perf_counter()
    kernels = (l2_ops.log2quant, bm_ops.bitplane_matmul,
               pa_ops.paged_attention, pa_ops.paged_attention_quant)
    cfg = get_config("smollm-135m")
    trace = serve_trace(cfg.vocab_size)
    print(f"phase 14: disaggregated serving (prefill and decode engines, "
          f"PageSpans between them), phase 7's trace and ServeConfig; on "
          f"{card}")
    params = init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    out = {}

    # (a) bf16 float, K3 on the dense paged pool: phase 7's graph run
    r = routed(torch, cfg, params, serve_config(
        quant=False, kernel=True, stats=False), trace, kernels)
    same_as_combined("smollm float K3", r["res"], combined["float"]["results"])
    n_dec = r["fwd"]["decode"]["decode"]
    check(r["replayed"]["paged_attention"] == cfg.n_layers * n_dec
          and r["replayed"]["paged_attention_quant"]
          == r["replayed"]["bitplane_matmul"]
          == r["replayed"]["log2quant"] == 0,
          f"float router: launches {r['replayed']}, expected K3 "
          f"{cfg.n_layers} x {n_dec} decode forwards and no other kernel")
    out["float_k3"] = report_routed("smollm float K3, router", r,
                                    combined["float"], cfg, card)
    out["float_k3"]["launches"] = r["replayed"]
    print(f"    tokens, finish reasons and rejects equal phase 7's combined "
          f"graph run for all {len(trace)} requests")
    del r

    # (b) packed planes with kv_quant: K2 and K4, phase 9's graph run
    pparams = quantize_model_params(cfg, params, pack=True)
    r = routed(torch, cfg, pparams, serve_config(
        quant=True, kernel=True, stats=False, kv_quant=True), trace, kernels)
    same_as_combined("smollm packed kv_quant K4", r["res"],
                     combined["kv_quant"]["results"])
    n_fwd = sum(sum(f.values()) for f in r["fwd"].values())
    n_dec = r["fwd"]["decode"]["decode"]
    check(r["replayed"]["paged_attention_quant"] == cfg.n_layers * n_dec
          and r["replayed"]["bitplane_matmul"]
          == cfg.n_layers * len(PROJ) * n_fwd
          and r["replayed"]["paged_attention"]
          == r["replayed"]["log2quant"] == 0,
          f"quantized router: launches {r['replayed']}, expected K4 "
          f"{cfg.n_layers} x {n_dec} decode forwards, K2 "
          f"{cfg.n_layers * len(PROJ)} x {n_fwd} forwards")
    out["packed_kv_quant_k4"] = report_routed(
        "smollm packed kv_quant K2+K4, router", r, combined["kv_quant"], cfg,
        card)
    out["packed_kv_quant_k4"]["launches"] = r["replayed"]
    print(f"    tokens, finish reasons and rejects equal phase 9's combined "
          f"graph run for all {len(trace)} requests")
    del r, pparams
    gc_cuda(torch)

    # (c) two processes on the card: prefill and decode workers rebuild
    # smollm-135m from seed 0; eight requests, one over max_len (rejected)
    rng = np.random.default_rng(14)
    over = rng.integers(0, cfg.vocab_size, size=SERVE["max_len"] - SERVE_NEW
                        + 1).astype(np.int32)
    # no two of them share a prefix: the combined scheduler admits all
    # eight at once, the prefill worker one after another
    two = trace[:5] + [over] + trace[8:10]
    sc = serve_config(quant=False, kernel=True, stats=False)
    sched = ServeScheduler(cfg, params, sc)
    for p in two:
        sched.submit(p, max_new=SERVE_NEW)
    want = [(x.tokens, x.finish_reason, x.error) for x in sched.run()]
    check(want[5][1] == "rejected" and want[5][2],
          "the over-long request was not rejected")
    del sched, params
    gc_cuda(torch)
    frames = []
    t0 = time.perf_counter()
    got, ticks = run_disaggregated(
        [(p, SERVE_NEW, None) for p in two], arch="smollm-135m", config=sc,
        smoke=False, f32=False, seed=0, device="cuda", timeout=300.0,
        frames=frames)
    wall = time.perf_counter() - t0
    check([g[0] for g in got] == list(range(len(two)))
          and [(t, r_, e) for _, t, r_, e in got] == want,
          f"two processes: results differ from the combined scheduler's: "
          f"{[(g[0], g[2]) for g in got]}")
    tt = p50_p95(ticks[1:])             # the first tick captures
    out["two_process"] = {"wall_s": wall, "decode_ticks": len(ticks),
                          "decode_capture_tick_ms": ticks[0] * 1e3,
                          "decode_tick_ms_p50_p95": tt,
                          "frame_bytes": frames}
    print(f"  two processes (spawn), {len(two)} requests (one over "
          f"max_len, rejected prefill-side): tokens, finish reasons and "
          f"errors equal the combined scheduler in this process; {wall:.1f} "
          f"s with both workers' start-up, model builds and captures; the "
          f"decode worker's {len(ticks)} ticks: the first (capture) "
          f"{ticks[0] * 1e3:.1f} ms, the others p50/p95 {tt[0]:.3f}/"
          f"{tt[1]:.3f} ms; bytes per frame {frames}")

    # (d) mamba2-780m: phase 10's graph run, its first MAMBA_ROUTED
    # requests (prefix-free: none of them can hit)
    mcfg = get_config("mamba2-780m")
    mparams = quantize_model_params(mcfg, init_params(
        mcfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev), pack=True)
    mtrace = serve_trace(mcfg.vocab_size)[:MAMBA_ROUTED]
    r = routed(torch, mcfg, mparams, serve_config(
        quant=True, kernel=False, stats=True), mtrace, kernels)
    same_as_combined("mamba2-780m packed", r["res"],
                     combined["mamba"]["results"][:MAMBA_ROUTED])
    n_fwd = sum(sum(f.values()) for f in r["fwd"].values())
    check(r["replayed"]["bitplane_matmul"]
          == mcfg.n_layers * len(MAMBA_PROJ) * n_fwd
          and r["replayed"]["log2quant"] == r["replayed"]["paged_attention"]
          == r["replayed"]["paged_attention_quant"] == 0,
          f"mamba router: launches {r['replayed']}, expected K2 "
          f"{mcfg.n_layers * len(MAMBA_PROJ)} x {n_fwd} forwards")
    out["mamba"] = report_routed("mamba2-780m packed quant+stats, router",
                                 r, combined["mamba"], mcfg, card)
    out["mamba"]["launches"] = r["replayed"]
    print(f"    tokens equal phase 10's combined graph run for its first "
          f"{MAMBA_ROUTED} requests")
    del r, mparams
    gc_cuda(torch)
    print(f"  (phase 14 took {time.perf_counter() - t_phase:.0f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 15: training
# ---------------------------------------------------------------------------

# full-width smollm-135m training: the synthetic data, micro-batches,
# AdamW and the step the resumed run restarts from
TRAIN = dict(global_batch=16, seq_len=1024, micro_batches=2, lr=3e-4,
             warmup_steps=5, steps=20, resume_at=10)
# the flash Function at smollm-135m's attention (B, S, H, G, D) and two
# KV chunkings (one chunk; four)
FLASH_SHAPE = (8, 1024, 9, 3, 64)
FLASH_CHUNKS = (1024, 256)
# gradient tolerances, as a share of each tensor's largest magnitude:
# smoke configs card against host (f32), the flash Function against plain
# autograd on the card in f32; at bf16 the Function must come as close to
# the f32 gradients as plain autograd's bf16 gradients do (twice their
# error, or 2^-7)
TRAIN_SMOKE_REL = 1e-4
FLASH_F32_REL = 2e-5
BF16_PEAK_FLOPS = 989e12            # H100 SXM dense bf16, NVIDIA data sheet


def rel_err(torch, got, want) -> float:
    """max |got - want| over max |want| (0 when both are 0), in f32."""
    got, want = got.float(), want.float()
    top = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return err / top if top else err


def train_batch(np, cfg, seed: int, b: int = 2, s: int = 16) -> dict:
    """A numpy training batch for a smoke config (tokens or the audio
    stub's embeddings, the vision stub's patch rows, labels, a 0/1
    mask)."""
    rng = np.random.default_rng(seed)
    out = {}
    st = s - cfg.n_image_tokens if cfg.frontend == "vision_stub" else s
    if cfg.frontend == "audio_stub":
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, st)).astype(
            np.int32)
    if cfg.frontend == "vision_stub":
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, st)).astype(np.int32)
    out["mask"] = (rng.random((b, st)) < 0.8).astype(np.float32)
    return out


def train_smoke_on_card(torch, dev) -> dict:
    """Every smoke config in f32: one step's loss and gradients on the card
    against the plain host run on the same weights and batch."""
    import numpy as np

    from repro_torch.configs import get_smoke, list_archs
    from repro_torch.models.model import init_params
    from repro_torch.train.trainer import make_loss_fn, value_and_grad
    from repro_torch.tree import flatten_with_path

    out = {}
    for i, name in enumerate(list_archs()):
        cfg = get_smoke(name).replace(dtype=torch.float32)
        host = init_params(cfg, generator=torch.Generator().manual_seed(7),
                           device="cpu")
        batch = {k: torch.from_numpy(v)
                 for k, v in train_batch(np, cfg, i).items()}
        lh, gh = value_and_grad(make_loss_fn(cfg), host, batch)
        lc, gc = value_and_grad(make_loss_fn(cfg), _to(torch, host, dev),
                                {k: v.to(dev) for k, v in batch.items()})
        loss_err = abs(float(lc) - float(lh)) / abs(float(lh))
        check(loss_err <= 1e-5, f"{name} smoke: loss on the card {float(lc)}"
              f" against {float(lh)} on the host")
        worst, at = 0.0, ""
        for (key, a), (_, b) in zip(flatten_with_path(gh),
                                    flatten_with_path(gc)):
            b = b.cpu()
            check(bool(torch.isfinite(b).all()), f"{name} {key}: a "
                  f"non-finite gradient on the card")
            e = rel_err(torch, b, a)
            if e >= worst:
                worst, at = e, key
        check(worst <= TRAIN_SMOKE_REL, f"{name} smoke: gradient {at} on "
              f"the card differs from the host's by {worst:.2e} of its "
              f"largest magnitude")
        out[name] = {"loss": float(lc), "loss_rel_err": loss_err,
                     "grad_rel_err": worst, "leaf": at}
        print(f"  {name} smoke f32: loss {float(lc):.6f} (host "
              f"{float(lh):.6f}), worst gradient {at} {worst:.2e} of its "
              f"largest magnitude")
    return out


def flash_on_card(torch, dev) -> dict:
    """The flash Function against torch autograd through the plain chunked
    forward at smollm-135m's attention, f32 and bf16, one chunk and four,
    and the tensors each saves for the backward (by
    ``saved_tensors_hooks``).  Returns the results and a function that
    adds the device time of a forward plus backward of each."""
    from repro_torch.models import attention

    b, s, h, g, d = FLASH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(15)
    pos = torch.arange(s, device=dev, dtype=torch.int32).expand(b, s)
    base = [torch.randn(shape, generator=gen, device=dev)
            for shape in ((b, s, h, d), (b, s, g, d), (b, s, g, d),
                          (b, s, h, d))]

    def run(fn, q, k, v, do, saved=None):
        ts = [t.detach().requires_grad_() for t in (q, k, v)]

        def pack(t):
            if saved is not None:
                saved.append((tuple(t.shape), t.numel() * t.element_size()))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn(*ts)
            grads = torch.autograd.grad(out, ts, do)
        return [out.detach()] + list(grads)

    def ms(fn, q, k, v, do, reps=3):
        run(fn, q, k, v, do)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            run(fn, q, k, v, do)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    res, timers = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(dtype) for t in base)
        for chunk in FLASH_CHUNKS:
            def fn(a, bb, c, chunk=chunk):
                return attention.flash_attention(a, bb, c, pos, pos,
                                                 kv_chunk=chunk)

            def plain(a, bb, c, chunk=chunk):
                return attention.flash_forward(a, bb, c, pos, pos, True,
                                               chunk)[0]

            saved, saved_plain = [], []
            got = run(fn, q, k, v, do, saved)
            want = run(plain, q, k, v, do, saved_plain)
            scores = [sh for sh, _ in saved if sh[-2:] == (s, chunk)]
            check(not scores, f"the flash Function saved score-shaped "
                  f"tensors {scores}")
            errs = [rel_err(torch, x, y) for x, y in zip(got, want)]
            tag = f"{str(dtype).split('.')[-1]} kv_chunk {chunk}"
            if dtype == torch.float32:
                check(max(errs) <= FLASH_F32_REL, f"flash {tag}: out, dq, "
                      f"dk, dv differ from plain autograd by {errs}")
                ref_errs = None
            else:
                f32 = run(plain, *(t.float() for t in (q, k, v, do)))
                ref_errs = [(rel_err(torch, x, r), rel_err(torch, y, r))
                            for x, y, r in zip(got, want, f32)]
                for name, (e_fn, e_plain) in zip(("out", "dq", "dk", "dv"),
                                                 ref_errs):
                    check(e_fn <= max(2 * e_plain, 2 ** -7), f"flash {tag} "
                          f"{name}: {e_fn:.2e} from the f32 gradients, plain "
                          f"autograd's bf16 {e_plain:.2e}")
            res[tag] = {"rel_err_vs_plain": errs, "vs_f32": ref_errs,
                        "saved_mb": sum(n for _, n in saved) / 1e6,
                        "plain_saved_mb": sum(n for _, n in saved_plain) / 1e6,
                        "plain_score_mb": sum(
                            n for sh, n in saved_plain
                            if sh[-2:] == (s, chunk)) / 1e6}
            timers.append((tag, fn, plain, (q, k, v, do)))
            print(f"  flash {tag}: out/dq/dk/dv vs plain autograd "
                  f"{', '.join(f'{e:.2e}' for e in errs)}"
                  + ("" if ref_errs is None else " (vs f32, Function / "
                     "plain: " + ", ".join(f"{a:.2e}/{p:.2e}"
                                           for a, p in ref_errs) + ")")
                  + f"; saved {res[tag]['saved_mb']:.1f} MB, no score-shaped"
                  f" tensor (plain autograd {res[tag]['plain_saved_mb']:.1f} "
                  f"MB, {res[tag]['plain_score_mb']:.1f} of them scores)")

    def times():
        """Device ms of a forward plus backward, the Function and plain
        autograd, on the inputs above (called when the card is quiet)."""
        for tag, fn, plain, xs in timers:
            res[tag]["fwd_bwd_ms"] = ms(fn, *xs)
            res[tag]["plain_fwd_bwd_ms"] = ms(plain, *xs)
            print(f"  flash {tag}: forward + backward "
                  f"{res[tag]['fwd_bwd_ms']:.3f} ms (plain autograd "
                  f"{res[tag]['plain_fwd_bwd_ms']:.3f})")

    return res, times


def train_flops(cfg, tokens: int, batch: int, seq: int) -> dict:
    """FLOPs of one training step: ``6 * N * tokens``, N the weights of
    every matmul (the projections and the head; the embedding lookup is
    none), plus the attention einsums as the flash path computes them,
    masked halves included: 2 forward and 5 backward products of
    ``2 * B * H * S^2 * D`` each, per layer."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
    n_mm = cfg.n_layers * per_layer + d * cfg.vocab_size
    dense = 6 * n_mm * tokens
    attn = 14 * batch * cfg.n_heads * seq * seq * hd * cfg.n_layers
    return {"matmul_params": n_mm, "dense": dense, "attention": attn,
            "total": dense + attn}


def profiled_train_step(torch, step_fn, params, opt, batch) -> dict:
    """One training step under ``torch.profiler`` (host and device): the
    device-busy time, the top five device ops, and the flash Function's
    forward and backward device time (each wrapped in a profiler range
    for this step only)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models.attention import FlashAttention

    fwd, bwd = FlashAttention.forward, FlashAttention.backward

    def f(ctx, *a):
        with record_function("flash.fwd"):
            return fwd(ctx, *a)

    def bw(ctx, *a):
        with record_function("flash.bwd"):
            return bwd(ctx, *a)

    FlashAttention.forward, FlashAttention.backward = (staticmethod(f),
                                                       staticmethod(bw))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(params, opt, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        FlashAttention.forward, FlashAttention.backward = (
            staticmethod(fwd), staticmethod(bwd))
    cuda = torch.autograd.DeviceType.CUDA

    def self_us(e):
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))

    def total_us(e):
        return float(getattr(e, "device_time_total", None)
                     or getattr(e, "cuda_time_total", 0.0))

    events = prof.key_averages()
    ranges = ("flash.fwd", "flash.bwd")
    ops = [e for e in events if e.device_type == cuda
           and e.key not in ranges]
    busy = sum(self_us(e) for e in ops) / 1e3
    flash = {r: sum(total_us(e) for e in events
                    if e.key == r and e.device_type != cuda) / 1e3
             for r in ranges}
    top = sorted(ops, key=self_us, reverse=True)[:5]
    return {"wall_ms": wall, "busy_ms": busy,
            "flash_fwd_ms": flash["flash.fwd"],
            "flash_bwd_ms": flash["flash.bwd"],
            "flash_share": (flash["flash.fwd"] + flash["flash.bwd"]) / busy
            if busy else None,
            "top": [(e.key[:60], self_us(e) / 1e3, e.count) for e in top]}


def train_full_width(torch, dev, kernels) -> dict:
    """Full-width smollm-135m in bf16 from seed 0: ``TRAIN['steps']``
    steps through ``train_loop``, the state saved with ``save_async`` at
    ``TRAIN['resume_at']``, then restored by a fresh manager into a fresh
    tree and trained to the end again: losses and final state bit-equal.
    Returns the run's log and end state for :func:`train_timing`."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, train_loop
    from repro_torch.tree import leaves

    cfg = get_config("smollm-135m")
    tr = TRAIN
    steps, mid = tr["steps"], tr["resume_at"]
    data = SyntheticLM(DataConfig(global_batch=tr["global_batch"],
                                  seq_len=tr["seq_len"],
                                  vocab_size=cfg.vocab_size, seed=0))
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(
        lr=tr["lr"], warmup_steps=tr["warmup_steps"], total_steps=steps),
        micro_batches=tr["micro_batches"])

    def batches(lo, hi):
        for st in range(lo, hi):
            yield {k: torch.from_numpy(v).to(dev)
                   for k, v in data.batch(st).items()}

    def hook_into(log):
        def hook(st, m):
            log[st] = (float(m["loss"]), float(m["grad_norm"]),
                       bool(m["straggler"]))
        return hook

    params = init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    opt = adamw.init(params)
    print(f"  {cfg.name} {cfg.n_layers}L d={cfg.d_model} vocab "
          f"{cfg.vocab_size} {cfg.dtype}: global batch {tr['global_batch']}"
          f" x {tr['seq_len']} tokens, {tr['micro_batches']} micro-batches, "
          f"AdamW lr {tr['lr']} (warmup {tr['warmup_steps']}, total "
          f"{steps})")
    log = {}
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        for kn in kernels:
            kn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params, opt, _ = train_loop(cfg, tcfg, params, opt,
                                    batches(0, mid), hook=hook_into(log))
        mgr = CheckpointManager(ckdir, keep=2)
        mgr.save_async(mid, {"params": params, "opt": opt})
        params, opt, _ = train_loop(cfg, tcfg, params, opt,
                                    batches(mid, steps), step0=mid,
                                    hook=hook_into(log))
        peak = torch.cuda.max_memory_allocated()
        launched = {kn.__name__: kn.launches for kn in kernels}
        check(not any(launched.values()), f"the training path launched a "
              f"serving kernel: {launched}")
        mgr.wait()
        losses = [log[st][0] for st in range(steps)]
        norms = [log[st][1] for st in range(steps)]
        check(all(math.isfinite(x) for x in losses + norms),
              f"non-finite loss or grad_norm: {losses} {norms}")
        check(losses[-1] <= losses[0] - 0.5, f"loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}: not 0.5 nats lower after {steps} steps")

        # a fresh manager restores into a fresh tree and trains again
        fresh = init_params(cfg, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev)
        state = CheckpointManager(ckdir).restore(
            mid, {"params": fresh, "opt": adamw.init(fresh)})
        del fresh
        relog = {}
        p2, o2, _ = train_loop(cfg, tcfg, state["params"], state["opt"],
                               batches(mid, steps), step0=mid,
                               hook=hook_into(relog))
        del state
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    for st in range(mid, steps):
        check(relog[st][:2] == log[st][:2], f"resumed step {st}: loss, "
              f"grad_norm {relog[st][:2]} against {log[st][:2]}")
    check(all(torch.equal(a, b) for a, b in zip(leaves((params, opt)),
                                                 leaves((p2, o2)))),
          "the resumed run's final params or optimizer state differ from "
          "the uninterrupted run's")
    del p2, o2
    print(f"  {steps} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"grad_norm {norms[0]:.3f} -> {norms[-1]:.3f}; resumed from step "
          f"{mid} by a fresh manager into a fresh tree: steps {mid}-"
          f"{steps - 1}'s losses, grad norms and the final params and "
          f"moments bit-equal; no serving kernel launched")
    return {"cfg": cfg, "tcfg": tcfg, "data": data, "params": params,
            "opt": opt, "log": {"losses": losses, "grad_norms": norms,
                                "peak_gb": peak / 1e9,
                                "stragglers": sum(log[st][2]
                                                  for st in range(steps))}}


def train_timing(torch, dev, card, run) -> dict:
    """On a quiet card, after :func:`train_full_width`: the step's host and
    device time with deterministic kernels and without (two steps each, on
    the batches after the run's), tokens/s, FLOPs and their share of the
    dense bf16 peak, one profiled step, and a synchronous save and a
    restore of the end state."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train.trainer import deterministic, make_train_step

    cfg, tcfg, data = run["cfg"], run["tcfg"], run["data"]
    params, opt = run["params"], run["opt"]
    tr = TRAIN
    step_fn = make_train_step(cfg, tcfg)
    extra = [{k: torch.from_numpy(v).to(dev)
              for k, v in data.batch(st).items()}
             for st in range(tr["steps"], tr["steps"] + 2)]

    def step_ms(det: bool):
        host, device = [], []
        for b in extra:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            with deterministic() if det else contextlib.nullcontext():
                t0 = time.perf_counter()
                e0.record()
                step_fn(params, opt, b)
                e1.record()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            device.append(e0.elapsed_time(e1))
        return host, device

    host_det, dev_det = step_ms(True)
    host_nd, dev_nd = step_ms(False)
    with deterministic():
        prof = profiled_train_step(torch, step_fn, params, opt, extra[0])
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_save_")
    try:
        mgr = CheckpointManager(ckdir)
        ts = time.perf_counter()
        mgr.save(tr["steps"], {"params": params, "opt": opt})
        t_save = time.perf_counter() - ts
        ck_bytes = sum(os.path.getsize(os.path.join(
            ckdir, f"step_{tr['steps']:08d}", fn))
            for fn in ("arrays.npz", "meta.json"))
        ts = time.perf_counter()
        mgr.restore(tr["steps"], {"params": params, "opt": opt})
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - ts
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    tokens = tr["global_batch"] * tr["seq_len"]
    flops = train_flops(cfg, tokens, tr["global_batch"], tr["seq_len"])
    dev_ms = min(dev_det)
    rate = flops["total"] / (dev_ms / 1e3)
    res = {"step_ms_host": host_det, "step_ms_device": dev_det,
           "step_ms_host_nondeterministic": host_nd,
           "step_ms_device_nondeterministic": dev_nd,
           "tokens_per_s": tokens / (dev_ms / 1e3),
           "tokens_per_s_host": tokens / (min(host_det) / 1e3),
           "flops": flops, "flops_per_s": rate,
           "bf16_peak_share": rate / BF16_PEAK_FLOPS,
           "save_s": t_save, "restore_s": t_restore,
           "checkpoint_bytes": ck_bytes, "profile": prof}
    print(f"  step (deterministic / not): host {host_det} / {host_nd} ms, "
          f"device {dev_det} / {dev_nd} ms; {res['tokens_per_s']:.0f} "
          f"tokens/s; peak {run['log']['peak_gb']:.2f} GB; "
          f"{flops['total']:.4e} FLOPs a step (6 N T {flops['dense']:.4e}, "
          f"attention einsums {flops['attention']:.4e}) = "
          f"{rate / 1e12:.1f} TFLOP/s, {res['bf16_peak_share']:.4f} of "
          f"{BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s dense bf16 ({card})")
    share = prof["flash_share"]
    print(f"  profiled step: {prof['wall_ms']:.1f} ms wall, device busy "
          f"{prof['busy_ms']:.1f} ms; flash forward {prof['flash_fwd_ms']:.1f}"
          f" + backward {prof['flash_bwd_ms']:.1f} ms = "
          + ("not measured (no device time in the trace)" if share is None
             else f"{share:.3f} of it")
          + f"; top device ops {prof['top']}")
    print(f"  checkpoint {ck_bytes / 1e9:.3f} GB: save {t_save:.2f} s, "
          f"restore {t_restore:.2f} s")
    return res


def cli_start(args) -> tuple:
    """``repro_torch.launch.train`` at full width (smollm-135m) in a child
    process with ``args``; :func:`cli_finish` collects it."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "smollm-135m", *args]
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env,
                             cwd=REPO), args, time.perf_counter())


def cli_finish(started) -> tuple:
    """Wait for a :func:`cli_start` child (killed past 240 s): its stdout,
    its logged steps and its seconds; a failure fails the phase."""
    proc, args, t0 = started
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"the training CLI {args} failed: "
          f"{err[-2000:]}")
    steps = [json.loads(x)["step"] for x in out.splitlines()
             if x.startswith("{")]
    return out, steps, time.perf_counter() - t0


def phase15(torch, dev, card, l2_ops, bm_ops, pa_ops) -> dict:
    """Training on the card: the smoke configs against the host, the flash
    Function against plain autograd, full-width smollm-135m through
    ``train_loop`` with a bit-equal resume, and the CLI in two child
    processes.  The children run beside the checks that time nothing;
    every time is taken after the second has ended."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    kernels = (l2_ops.log2quant, bm_ops.bitplane_matmul,
               pa_ops.paged_attention, pa_ops.paged_attention_quant)
    print("phase 15: training")
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    base = ["--checkpoint-dir", ckdir, "--checkpoint-every", "2"]
    child = None
    try:
        child = cli_start(base + ["--steps", "4"])
        out = {"smoke": train_smoke_on_card(torch, dev)}
        out1, steps1, t1 = cli_finish(child)
        check(steps1 == [0, 1, 2, 3] and "[train] done" in out1,
              f"the first CLI run logged steps {steps1}")
        child = cli_start(base + ["--steps", "6", "--resume", "auto"])
        out["flash"], flash_times = flash_on_card(torch, dev)
        run = train_full_width(torch, dev, kernels)
        out2, steps2, t2 = cli_finish(child)
        child = None
    finally:
        if child is not None and child[0].poll() is None:
            child[0].kill()
            child[0].wait()
        shutil.rmtree(ckdir, ignore_errors=True)
    check("[train] resumed from step 4" in out2 and steps2 == [4, 5]
          and '"step": 3' not in out2,
          f"the resumed CLI run: {out2[-1000:]}")
    for line in (out1 + out2).splitlines():
        print(f"    | {line}")
    print(f"  the CLI at full width: 4 steps in {t1:.1f} s, resumed at step "
          f"4 to 6 in {t2:.1f} s (child processes, start-up included, beside "
          f"the checks above)")
    out["cli"] = {"first_s": t1, "resumed_s": t2}
    # timed on a quiet card
    flash_times()
    out["full_width"] = {**run["log"],
                         **train_timing(torch, dev, card, run)}
    del run
    gc_cuda(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  (phase 15 took {out['phase_s']:.0f} s)")
    return out

if __name__ == "__main__":
    main()
