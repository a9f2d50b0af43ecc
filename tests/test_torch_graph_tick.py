"""The port's serving programs (``serving/engine.py::Program``) on the
host, where each body runs eagerly into its static buffers, held against
the JAX package on the smoke config at f32:

* ``ServeScheduler.compile_stats()`` equals the reference scheduler's on
  the same ``ServeConfig`` and traffic: the bucketed case of
  ``tests/test_serve_scheduler.py`` (two buckets, six prompt lengths) and
  the ``"always"`` and ``"auto"`` chunked cases of
  ``tests/test_serve_chunked.py``; tokens equal too;
* every tensor a program reads by address (pool leaves, lengths, logits,
  the prefill's static cache, every static input buffer) keeps its
  ``data_ptr()`` across ticks, admissions, copies on write and
  retirements, dense, paged and ``kv_quant``; rebinding one raises;
* ``generate_cache_size`` bounds the one-shot program LRU, and
  ``set_generate_cache_size`` / ``clear_generate_cache`` behave as the
  reference's, the scheduler sizing the bound from its ``ServeConfig``;
* with ``eos_id`` the one-shot program, which runs every forward, gives
  the reference ``while_loop``'s tokens and per-step stats (within 1e-6),
  zero for every forward after all rows are done;
* on the mamba2-780m smoke config the same ``compile_stats()`` cases
  equal the reference's, the programs' addresses hold over SSM snapshots
  and their restores, every slot's SSM/conv state is in the tick, chunk
  and mixed programs' ``carry`` (a warm-up advances it), and a run under
  ``engine.eager()`` equals the program run in tokens and final state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_params as jax_init_params
from repro.models.quantize import quantize_model_params as jax_quantize
from repro.serving import engine as jax_engine
from repro.serving.config import ServeConfig as JaxServeConfig
from repro.serving.scheduler import ServeScheduler as JaxScheduler
from repro_torch.configs import get_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import ServeConfig, ServeScheduler, engine

# (ServeConfig fields, prompt lengths, max_new): the traffic of the
# reference's own compile-count tests
STATS_CASES = {
    "buckets": (dict(max_slots=2, max_len=48, buckets=(8, 16), tick_steps=3),
                (5, 8, 3, 12, 7, 9), 4),
    "chunked_always": (dict(max_slots=3, max_len=64, buckets=(8, 16),
                            tick_steps=4, chunked="always"),
                       (1, 7, 8, 9, 16, 24, 40, 56), 7),
    "chunked_auto": (dict(max_slots=2, max_len=64, buckets=(8, 16),
                          tick_steps=4, chunked="auto"),
                     (1, 7, 8, 9, 16, 24, 40, 56), 7),
}
PAGED = dict(max_slots=3, max_len=64, buckets=(8, 16), tick_steps=4,
             paged=True, page_len=4, prefix_cache=True, chunked="auto",
             chunk_len=8, attn_kernel="pallas", attn_splits=2)
PTR_MODES = {
    "dense": dict(max_slots=3, max_len=64, buckets=(8, 16), tick_steps=4,
                  chunked="auto", chunk_len=8),
    "paged": PAGED,
    "kv_quant": dict(PAGED, kv_quant=True, kv_bits=4),
}


@pytest.fixture(scope="module")
def mamba_model():
    jcfg = jax_get_smoke("mamba2_780m").replace(dtype=jnp.float32)
    cfg = get_smoke("mamba2-780m").replace(dtype=torch.float32)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_smoke("smollm_135m").replace(dtype=jnp.float32)
    cfg = get_smoke("smollm-135m").replace(dtype=torch.float32)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


def _prompts(lengths, vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_compile_stats_equal_reference(model, case):
    kw, lengths, max_new = STATS_CASES[case]
    jcfg, jparams, cfg, params = model
    prompts = _prompts(lengths, cfg.vocab_size)
    jsched = JaxScheduler(jcfg, jparams, JaxServeConfig(**kw))
    sched = ServeScheduler(cfg, params, ServeConfig(**kw), device="cpu")
    for s in (jsched, sched):
        for p in prompts:
            s.submit(p, max_new=max_new)
    jres, res = jsched.run(), sched.run()
    assert [r.tokens for r in res] == [list(map(int, r.tokens))
                                       for r in jres]
    assert sched.compile_stats() == jsched.compile_stats()
    stats = sched.compile_stats()
    assert stats["tick"] == 1 and stats["prefill"] <= len(kw["buckets"])
    if "chunk" in stats:
        assert stats["chunk"] == 1 and stats["mixed"] <= 1


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_mamba_compile_stats_equal_reference(mamba_model, case):
    test_compile_stats_equal_reference(mamba_model, case)


def _addresses(sched):
    """``{name: data_ptr}`` of everything the programs read by address."""
    out = {"logits": sched._logits.data_ptr(),
           "logits1": sched._logits1.data_ptr(),
           "length": sched._pool["length"].data_ptr()}
    for tree, tag in ((sched._pool, "pool"), (sched._cache1, "cache1")):
        for li, layer in enumerate(tree["layers"]):
            for k, t in layer.items():
                out[f"{tag}/{li}/{k}"] = t.data_ptr()
    for name, prog in sched.programs().items():
        for key, t in prog.static_inputs().items():
            out[f"{name}/{key}"] = t.data_ptr()
    return out


@pytest.mark.parametrize("mode", list(PTR_MODES))
def test_program_buffers_keep_their_addresses(model, mode):
    """Three slots over eight requests (retirements and re-admissions),
    bucketed and chunked admissions (a chunk-only tick, then mixed
    ones), and in the paged modes prefix hits
    that copy a partial page on write: no address a program reads ever
    changes, and the pool dict is the same object throughout."""
    _, _, cfg, params = model
    rng = np.random.default_rng(0)

    def tok(n):
        return rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)

    stem = tok(10)
    prompts = [np.concatenate([stem, tok(3)]), tok(5), tok(21)]
    prompts += [np.concatenate([stem, tok(4)]), prompts[1].copy(),
                np.concatenate([stem, tok(5)]), tok(9), tok(7)]
    sched = ServeScheduler(cfg, params, ServeConfig(**PTR_MODES[mode]),
                           device="cpu")
    pool, length = sched._pool, sched._pool["length"]
    cows = []
    cow = sched._cow
    sched._cow = lambda src, dst: (cows.append(src), cow(src, dst))
    # the long prompt alone first: a chunk-only tick
    sched.submit(prompts[2], max_new=6)
    seen = _addresses(sched)
    ticks = 0
    while sched.pending:
        if ticks == 1:
            for p in prompts[:2] + prompts[3:]:
                sched.submit(p, max_new=6)
        assert sched.step_tick()
        ticks += 1
        now = _addresses(sched)
        for key, ptr in seen.items():
            assert now[key] == ptr, f"{key} moved at tick {ticks}"
        seen.update(now)
        assert sched._pool is pool and sched._pool["length"] is length
    results = sched.run()
    assert all(len(r.tokens) == 6 for r in results)
    assert max(r.admitted_tick for r in results) > 0        # slots reused
    stats = sched.compile_stats()
    assert stats["prefill"] >= 1 and stats["chunk"] == 1 and \
        stats["mixed"] == 1
    assert len(cows) == (0 if mode == "dense" else 2)


def test_rebinding_a_bound_tensor_raises(model):
    """A program refuses to run once a tensor it reads by address was
    rebound: on the card a replay would read dead memory."""
    _, _, cfg, params = model
    sched = ServeScheduler(cfg, params, ServeConfig(**PTR_MODES["dense"]),
                           device="cpu")
    sched.submit(np.arange(5, dtype=np.int32), max_new=6)
    assert sched.step_tick()
    sched._pool["length"] = sched._pool["length"].clone()
    with pytest.raises(RuntimeError, match="rebound"):
        sched.step_tick()


def test_generate_cache_bounds_and_sizing(model):
    """The LRU of one-shot programs, next to the reference's: the same
    operations give the same sizes and bounds."""
    jcfg, jparams, cfg, params = model
    jprompt = jnp.zeros((1, 4), jnp.int32)
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    mods = (jax_engine, engine)
    olds = [m.generate_fn.maxsize for m in mods]
    try:
        for m in mods:
            m.clear_generate_cache()
            m.set_generate_cache_size(2)
        for max_new in (2, 3, 4, 3):
            jax_engine.greedy_generate(jcfg, jparams, jprompt, max_new)
            engine.greedy_generate(cfg, params, prompt, max_new,
                                   device="cpu")
            assert len(engine.generate_fn) == len(jax_engine.generate_fn)
        assert len(engine.generate_fn) == 2
        # a second prompt shape is a second signature of the same program
        engine.greedy_generate(cfg, params, torch.zeros(
            (2, 5), dtype=torch.int32), 3, device="cpu")
        assert len(engine.generate_fn) == 2
        assert max(engine.compiled_size(g.program)
                   for g in engine.generate_fn._data.values()) == 2
        for m in mods:
            with pytest.raises(ValueError):
                m.set_generate_cache_size(0)
            m.set_generate_cache_size(1)
        assert len(engine.generate_fn) == len(jax_engine.generate_fn) == 1
        for m in mods:
            m.clear_generate_cache()
        assert len(engine.generate_fn) == len(jax_engine.generate_fn) == 0
        # the scheduler sets the bound from its ServeConfig: explicitly,
        # or by growing it to 4 x buckets + 16
        ServeScheduler(cfg, params, ServeConfig(
            max_slots=1, max_len=32, buckets=(8,), generate_cache_size=97),
            device="cpu")
        JaxScheduler(jcfg, jparams, JaxServeConfig(
            max_slots=1, max_len=32, buckets=(8,), generate_cache_size=97))
        assert engine.generate_fn.maxsize == jax_engine.generate_fn.maxsize \
            == 97
        for m in mods:
            m.set_generate_cache_size(3)
        ServeScheduler(cfg, params, ServeConfig(
            max_slots=1, max_len=32, buckets=(8, 16)), device="cpu")
        JaxScheduler(jcfg, jparams, JaxServeConfig(
            max_slots=1, max_len=32, buckets=(8, 16)))
        assert engine.generate_fn.maxsize == jax_engine.generate_fn.maxsize \
            == 4 * 2 + 16
    finally:
        for m, old in zip(mods, olds):
            m.clear_generate_cache()
            m.set_generate_cache_size(old)


def test_eos_program_matches_reference_while_loop(model):
    """Two rows that emit one token at different steps, both well before
    the end: the program runs every forward, the reference stops; tokens
    equal, stats equal, and zero from the step at which every row is
    done (the reference skipped those forwards)."""
    jcfg, jparams, cfg, params = model
    jq, q = jax_quantize(jcfg, jparams), quantize_model_params(cfg, params)
    max_new = 10
    prompts = np.stack(_prompts((6,) * 8, cfg.vocab_size))
    free = engine.greedy_generate(cfg, q, torch.from_numpy(prompts),
                                  max_new, quant=True, device="cpu").numpy()
    # the first token id and row pair whose first hits differ and both
    # land before max_new - 2
    pick = None
    for eos in np.unique(free[:, : max_new - 3]):
        first = [int(np.nonzero(r == eos)[0][0]) if (r == eos).any() else
                 None for r in free]
        rows = [i for i, f in enumerate(first)
                if f is not None and f < max_new - 3]
        for a in rows:
            for b in rows:
                if first[a] < first[b]:
                    pick = (int(eos), a, b)
                    break
            if pick:
                break
        if pick:
            break
    assert pick is not None, "no token id that two rows emit early"
    eos, a, b = pick
    rows = prompts[[a, b]]
    free2 = engine.greedy_generate(cfg, q, torch.from_numpy(rows), max_new,
                                   quant=True, device="cpu").numpy()
    done_at = max(int(np.nonzero(r == eos)[0][0]) for r in free2)
    assert done_at < max_new - 2
    jt, js = jax_engine.greedy_generate(jcfg, jq, jnp.asarray(rows), max_new,
                                        quant="xla", eos_id=eos,
                                        with_stats=True)
    t, st = engine.greedy_generate(cfg, q, torch.from_numpy(rows), max_new,
                                   quant=True, eos_id=eos, with_stats=True,
                                   device="cpu")
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert (t.numpy()[:, done_at:] == eos).all()
    for key in ("plane_traffic_fraction", "element_traffic_fraction"):
        got = st[key].numpy()
        np.testing.assert_allclose(got, np.asarray(js[key]), rtol=0,
                                   atol=1e-6)
        assert (got[:done_at] > 0).all() and (got[done_at:] == 0).all()


def test_colliding_page_writes_resolve_last_wins():
    """Rows that collide on the trash page (masked rows, and rows of a
    free slot whose table is all trash) resolve as a serial scatter does:
    the last row wins; the quantized write gives the same codes and
    scales with the slots computed by its caller or by itself."""
    from repro_torch.models.attention import (_paged_write, _quant_paged_write,
                                              page_slots)

    gen = torch.Generator().manual_seed(3)
    b, s, g, d, pl, n_pages = 3, 5, 2, 4, 4, 6
    table = torch.tensor([[1, 2], [0, 0], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [2, 3, 4, 5, 6]])
    keep = torch.tensor([[True] * 5, [True] * 5, [True, False, True,
                                                  False, True]])
    new = torch.randn((b, s, g, d), generator=gen)
    pool = torch.zeros((n_pages, pl, g, d))
    _paged_write(pool, page_slots(table, pos, keep, n_pages, pl), new)
    want = torch.zeros_like(pool)
    for i in range(b):
        for j in range(s):
            p = int(pos[i, j])
            blk = p // pl
            ok = bool(keep[i, j]) and blk < table.shape[1]
            page = int(table[i, min(blk, table.shape[1] - 1)]) if ok else 0
            want[page, p % pl if ok else 0] = new[i, j]
    assert torch.equal(pool, want)

    codes = torch.zeros((n_pages, pl, g, d), dtype=torch.int8)
    scale = torch.zeros((n_pages, g), dtype=torch.int32)
    tail = torch.zeros((b, 2 * pl + 1, g, d))
    start = pos[:, 0].to(torch.int32)
    _quant_paged_write(codes, scale, tail, table, new, pos, keep, start, s, 4)
    serial_codes, serial_scale = codes.clone(), scale.clone()
    for _ in range(2):
        codes.zero_(), scale.zero_()
        _quant_paged_write(codes, scale, tail, table, new, pos, keep, start,
                           s, 4, page_slots(table, pos, keep, n_pages, pl))
        assert torch.equal(codes, serial_codes)
        assert torch.equal(scale, serial_scale)


MAMBA_PAGED = dict(max_slots=2, max_len=64, buckets=(8, 16), tick_steps=3,
                   paged=True, page_len=8, prefix_cache=True,
                   chunked="auto", chunk_len=8)


def _mamba_trace(vocab):
    """Two page-aligned prefix owners (one bucketed, one chunked whose last
    chunk lands on the page boundary), then prompts that hit them, and a
    prefix-free long prompt."""
    rng = np.random.default_rng(4)

    def tok(n):
        return rng.integers(0, vocab, size=n).astype(np.int32)

    a, b = tok(16), tok(24)
    return [a, b, np.concatenate([a, tok(5)]), tok(30),
            np.concatenate([b, tok(3)]), np.concatenate([a, tok(9)])]


def test_mamba_programs_carry_state_and_keep_addresses(mamba_model):
    """Every SSM/conv leaf is carried by the tick, chunk and mixed
    programs; no address a program reads moves over admissions, snapshots,
    their restores and retirements; the hits are served."""
    _, _, cfg, params = mamba_model
    sched = ServeScheduler(cfg, params, ServeConfig(**MAMBA_PAGED),
                           device="cpu")
    leaves = [t for c in sched._pool["layers"] for t in c.values()]
    for name in ("tick", "chunk", "mixed"):
        carried = {t.data_ptr() for t in sched.programs()[name].carry}
        assert all(t.data_ptr() in carried for t in leaves), name
    for p in _mamba_trace(cfg.vocab_size):
        sched.submit(p, max_new=5)
    seen = _addresses(sched)
    while sched.pending:
        assert sched.step_tick()
        now = _addresses(sched)
        for key, ptr in seen.items():
            assert now[key] == ptr, key
        seen.update(now)
    assert all(len(r.tokens) == 5 for r in sched.run())
    st = sched.prefix_cache_stats()
    assert st["lookup_hits"] == 3 and st["cached_tokens"] == 16 + 24 + 16


def test_mamba_eager_run_equals_program_run(mamba_model):
    """The same trace through the programs and under ``engine.eager()``:
    equal tokens, lengths and SSM/conv state after the run, and equal to
    the reference scheduler's tokens."""
    jcfg, jparams, cfg, params = mamba_model
    prompts = _mamba_trace(cfg.vocab_size)
    runs = []
    for eager in (False, True):
        sched = ServeScheduler(cfg, params, ServeConfig(**MAMBA_PAGED),
                               device="cpu")
        for p in prompts:
            sched.submit(p, max_new=5)
        if eager:
            with engine.eager():
                res = sched.run()
        else:
            res = sched.run()
        runs.append(([r.tokens for r in res], sched._pool))
    (toks, pool), (etoks, epool) = runs
    assert toks == etoks
    assert torch.equal(pool["length"], epool["length"])
    for c, ec in zip(pool["layers"], epool["layers"]):
        for k in c:
            assert torch.equal(c[k], ec[k]), k
    jsched = JaxScheduler(jcfg, jparams, JaxServeConfig(**MAMBA_PAGED))
    for p in prompts:
        jsched.submit(p, max_new=5)
    assert toks == [list(map(int, r.tokens)) for r in jsched.run()]
