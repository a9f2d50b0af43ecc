"""The port's continuous-batching ``ServeScheduler`` held against the JAX
package's on the smoke config at f32: the same ``ServeConfig``, the same
weights (``models.convert``) and the same prompts, driven tick by tick.

Equal in every mode: the return of each ``step_tick``, every request's
tokens, ``finish_reason``, admitted and finished ticks and rejection
error, the per-slot lengths after each tick, ``prefix_cache_stats()``, and
the pool metadata (page tables, refcounts, free list, radix size) after
each tick.  Modes: dense bucketed, chunked "always", paged with the prefix
cache read through the gather and through the paged-attention kernel's
plain version with splits 1 and 2, quantized paged with the kernel and
stats, a copy-on-write partial-page hit, and pool exhaustion under the
reject, truncate and raise policies.

Per-request traffic fractions agree within 1e-6.  They are means of
ratios of integer plane counts; a single LOG2 code flipped on any row of
any projection would move a request's fraction by about 1e-4 at these
sizes, so the bar says every code agreed and leaves room only for the
float division.  Every trace fills every slot on its first tick: a slot
that was never admitted decodes junk from an empty cache, which the
reference's gather and kernel paths (and the port's kernel, which skips
pages past a row's length) compute differently, and that junk enters the
batch-aggregate stats.  The reference runs ``quant="xla"``, which is
bit-identical to its Pallas path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_params as jax_init_params
from repro.models.quantize import quantize_model_params as jax_quantize
from repro.serving.config import ServeConfig as JaxServeConfig
from repro.serving.scheduler import ServeScheduler as JaxScheduler
from repro_torch.configs import get_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import ServeConfig, ServeScheduler

BASE = dict(max_slots=3, max_len=64, buckets=(8, 16), tick_steps=4)
PAGED = dict(BASE, paged=True, page_len=4, prefix_cache=True,
             chunked="auto", chunk_len=8)
MODES = {
    "dense": (dict(BASE), False),
    "chunked_always": (dict(BASE, chunked="always", chunk_len=8), False),
    "paged_gather": (dict(PAGED), False),
    "paged_k3_s1": (dict(PAGED, attn_kernel="pallas", attn_splits=1), False),
    "paged_k3_s2": (dict(PAGED, attn_kernel="pallas", attn_splits=2), False),
    "quant_paged_k3_stats": (dict(PAGED, attn_kernel="pallas",
                                  attn_splits=2, quant="xla",
                                  with_stats=True), True),
}


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_smoke("smollm_135m").replace(dtype=jnp.float32)
    cfg = get_smoke("smollm-135m").replace(dtype=torch.float32)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jq = jax_quantize(jcfg, jparams)
    return {False: (jcfg, jparams, cfg, params),
            True: (jcfg, jq, cfg, quantize_model_params(cfg, params))}


def _prompts():
    """Three requests fill the three slots on the first tick; after they
    retire, the next three hit the prefix cache: ``prompts[3]`` and
    ``prompts[5]`` share 10 tokens with ``prompts[0]``, whose 3 donated
    pages hold 12 (2 whole pages aliased, 2 tokens of the third copied on
    write), ``prompts[4]`` repeats ``prompts[1]``; ``prompts[6]`` is
    chunked (over the largest bucket) when chunking is on and rejected
    when it is off."""
    rng = np.random.default_rng(0)

    def tok(n):
        return rng.integers(0, 256, size=n).astype(np.int32)

    stem = tok(10)
    p = [np.concatenate([stem, tok(3)]), tok(5), tok(9)]
    p += [np.concatenate([stem, tok(4)]), p[1].copy(),
          np.concatenate([stem, tok(5)]), tok(21), tok(7)]
    return p


def _snapshot(sched):
    out = {"length": np.asarray(sched._pool["length"]).tolist(),
           "active": sched._active.tolist()}
    if sched.paged:
        out.update(table=sched._table.tolist(),
                   refcount=sched._pages.refcount.tolist(),
                   free=list(sched._pages._free),
                   radix=(sched._radix.n_pages
                          if sched._radix is not None else None),
                   stats=sched.prefix_cache_stats())
    return out


def _step(sched):
    try:
        return sched.step_tick(), None
    except ValueError as e:
        return None, str(e)


def _drive(sched, prompts, max_new):
    rids = [sched.submit(p, max_new=max_new) for p in prompts]
    log = []
    while sched.pending:
        ret, err = _step(sched)
        log.append((ret, err, _snapshot(sched)))
        if err is not None or not ret:
            break
    return rids, log, sched.run() if log and log[-1][1] is None else None


def _result(r):
    return (r.rid, r.prompt_len, r.tokens, r.finish_reason, r.admitted_tick,
            r.finished_tick, r.error)


def _compare(ref, ours):
    (jrids, jlog, jres), (rids, log, res) = ref, ours
    assert rids == jrids
    assert len(log) == len(jlog)
    for t, (a, b) in enumerate(zip(jlog, log)):
        assert a == b, f"tick {t}"
    if jres is None:
        assert res is None
        return
    assert [_result(r) for r in res] == [_result(r) for r in jres]
    for a, b in zip(jres, res):
        for key in ("plane_traffic_fraction", "element_traffic_fraction"):
            x, y = getattr(a, key), getattr(b, key)
            assert (np.isnan(x) and np.isnan(y)) or abs(x - y) <= 1e-6, key


def _run_both(model, kw, quant, prompts, max_new):
    jcfg, jparams, cfg, params = model[quant]
    ref = _drive(JaxScheduler(jcfg, jparams, JaxServeConfig(**kw)),
                 prompts, max_new)
    ours = _drive(ServeScheduler(cfg, params, ServeConfig(**kw),
                                 device="cpu"), prompts, max_new)
    return ref, ours


@pytest.mark.parametrize("mode", list(MODES))
def test_scheduler_matches_reference(model, mode):
    kw, quant = MODES[mode]
    ref, ours = _run_both(model, kw, quant, _prompts(), max_new=6)
    _compare(ref, ours)
    results = ours[2]
    served = [r for r in results if r.finish_reason != "rejected"]
    assert all(len(r.tokens) == 6 for r in served)
    if kw.get("chunked", "off") == "off":
        assert results[6].finish_reason == "rejected"
    else:
        assert len(served) == len(results)
    if kw.get("prefix_cache"):
        stats = ours[1][-1][2]["stats"]
        # prompts 3 and 5 each alias 2 pages of prompt 0 and copy 2
        # tokens of its third on write; prompt 4 aliases 1 page
        assert stats["cached_tokens"] == 10.0 + 4.0 + 10.0
    if kw.get("with_stats"):
        assert all(0 < r.plane_traffic_fraction <= 1 for r in served)


def test_cow_partial_page_hit_matches_reference(model):
    """One slot: the donor retires, then a prompt that matches one whole
    cached page and 3 tokens of the next is admitted through a
    copy-on-write of that page."""
    rng = np.random.default_rng(3)
    stem = rng.integers(0, 256, size=7).astype(np.int32)
    prompts = [np.concatenate([stem, rng.integers(0, 256, size=2)]),
               np.concatenate([stem, rng.integers(0, 256, size=3)])]
    prompts = [p.astype(np.int32) for p in prompts]
    kw = dict(PAGED, max_slots=1, attn_kernel="pallas", attn_splits=2)
    ref, ours = _run_both(model, kw, False, prompts, max_new=5)
    _compare(ref, ours)
    assert ours[1][-1][2]["stats"]["cached_tokens"] == 7.0


@pytest.mark.parametrize("oversize", ["reject", "truncate", "raise"])
def test_pool_exhaustion_matches_reference(model, oversize):
    """A pool of 2 usable pages: a request needing 3 follows the oversize
    policy (rejected with an error, truncated to the latest tokens that
    fit, or raised) while the other request serves."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (12, 3)]
    kw = dict(max_slots=1, max_len=32, buckets=(8, 16), tick_steps=2,
              paged=True, page_len=8, n_pages=3, oversize=oversize)
    ref, ours = _run_both(model, kw, False, prompts, max_new=4)
    _compare(ref, ours)
    if oversize == "raise":
        assert "page pool exhausted" in ours[1][-1][1]
    else:
        first = ours[2][0]
        assert first.finish_reason == ("rejected" if oversize == "reject"
                                       else "length")


def test_continuous_cli_serves_on_the_host(capsys, tmp_path):
    """``launch.serve --continuous`` on the smoke config, paged with the
    prefix cache and the kernel's plain version, from a committed config
    file: every request served, hits reported."""
    from repro_torch.launch import serve

    common = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
              "--continuous", "--prefix-cache", "--attn-kernel",
              "--attn-splits", "2", "--chunked", "--page-len", "4",
              "--requests", "6", "--max-slots", "3", "--new-tokens", "4",
              "--prompt-len", "8"]
    path = tmp_path / "serve.json"
    serve.main(common + ["--dump-config", str(path)])
    results = serve.main(common + ["--config", str(path)])
    out = capsys.readouterr().out
    assert len(results) == 6
    assert all(r.finish_reason == "length" and len(r.tokens) == 4
               for r in results)
    assert "prefix cache: hit_rate" in out and "tok/s" in out


@pytest.mark.parametrize("paged,kernel", [(False, False), (True, False),
                                          (True, True)])
def test_slot_steps_logits_match_reference(model, paged, kernel):
    """The engine's slot-pool steps, one chunk then two decode steps with
    per-slot lengths (one row inactive), against the reference's: logits
    within rtol = atol = 1e-5 (XLA and ATen sum in other orders, as in
    tests/test_torch_model.py), per-slot lengths equal."""
    from repro.models.model import init_caches as jax_init_caches
    from repro.models.model import init_paged_pool as jax_init_pool
    from repro.serving import engine as jax_engine
    from repro_torch.models.model import init_caches, init_paged_pool
    from repro_torch.serving import engine

    jcfg, jparams, cfg, params = model[False]
    if kernel:
        jcfg = jcfg.replace(paged_attn_kernel="pallas", paged_attn_splits=2)
        cfg = cfg.replace(paged_attn_kernel="pallas", paged_attn_splits=2)
    b, max_len, page_len, n_pages = 3, 32, 4, 30
    if paged:
        jpool = jax_init_pool(jcfg, b, max_len, n_pages, page_len)
        pool = init_paged_pool(cfg, b, max_len, n_pages, page_len,
                               device="cpu")
        table = np.zeros((b, max_len // page_len), np.int32)
        table[0, :5] = [3, 9, 4, 1, 2]
        table[1, :4] = [5, 6, 7, 8]               # row 2 stays on trash
        pt = (jnp.asarray(table),)
        tpt = (torch.from_numpy(table),)
    else:
        jpool = jax_init_caches(jcfg, b, max_len, per_slot=True)
        pool = init_caches(cfg, b, max_len, device="cpu", per_slot=True)
        pt = tpt = ()
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 256, size=(b, 8)).astype(np.int32)
    valid = np.asarray([8, 5, 0], np.int32)
    flags = (np.asarray([True, True, False]), np.asarray([True, True, False]))
    jchunk = jax_engine.make_slot_prefill_chunk(jcfg, paged=paged)
    chunk = engine.make_slot_prefill_chunk(cfg, paged=paged)
    jlog = jnp.zeros((b, jcfg.vocab_size), jnp.float32)
    jl, jpool = jchunk(jparams, jpool, jlog, jnp.asarray(tokens),
                       jnp.asarray(valid), *map(jnp.asarray, flags), *pt)
    tl, pool = chunk(params, pool, torch.zeros((b, cfg.vocab_size)),
                     torch.from_numpy(tokens), torch.from_numpy(valid),
                     *map(torch.from_numpy, flags), *tpt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    jstep = jax_engine.make_slot_serve_step(jcfg, paged=paged)
    step = engine.make_slot_serve_step(cfg, paged=paged)
    active = np.asarray([True, False, True])
    for _ in range(2):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jpool = jstep(jparams, jpool, jnp.asarray(tok),
                          jnp.asarray(active), *pt)
        tl, pool = step(params, pool, torch.from_numpy(tok),
                        torch.from_numpy(active), *tpt)
        live = valid > 0          # rows with a real token in the cache
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(pool["length"].numpy(),
                                      np.asarray(jpool["length"]))
