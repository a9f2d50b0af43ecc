"""The dense config variants of the port (qwen3-32b with ``qk_norm``,
qwen2.5-14b with ``qkv_bias``, phi4-mini-3.8b) and ``drop_float``, held
against the JAX package at f32 on the smoke configs.

The reference initializes the biases ``bq/bk/bv`` to 0, the norm weights
``q_norm/k_norm`` to 1 and the vision stub's ``img_proj`` to a plain
draw, so every parity test first replaces them in the reference's numpy
tree with seeded random values (:func:`randomized`) and hands that tree to
both frameworks: a zero bias or a unit norm would hide a missing term.

Float logits agree within rtol = atol = 1e-5 (XLA and ATen sum in other
orders), greedy tokens and scheduler ticks exactly, plane-traffic
fractions within 1e-6 (``tests/test_torch_engine.py``,
``tests/test_torch_scheduler.py``).  The reference runs ``quant="xla"``,
bit-identical to its Pallas path.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALIASES as JAX_ALIASES
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.configs import list_archs as jax_list_archs
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models.quantize import quantize_model_params as jax_quantize
from repro.serving import engine as jax_engine
from repro.serving.config import ServeConfig as JaxServeConfig
from repro.serving.scheduler import ServeScheduler as JaxScheduler
from repro_torch.configs import ALIASES, get_config, get_smoke, list_archs
from repro_torch.models import layers, model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import ServeConfig, ServeScheduler, engine
from test_torch_scheduler import PAGED, _compare, _drive, _prompts

NEW = ["qwen3_32b", "qwen25_14b", "phi4_mini_3p8b", "internvl2_26b",
       "musicgen_medium"]
DENSE = ["qwen3_32b", "qwen25_14b", "phi4_mini_3p8b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def randomized(tree, seed=0):
    """The reference's numpy tree with ``bq/bk/bv`` N(0, 0.5), ``q_norm``/
    ``k_norm`` 1 + N(0, 0.3) and ``img_proj`` N(0, 1/d) in place of their
    constant inits; the other leaves as they were."""
    rng = np.random.default_rng(seed)

    def draw(a, loc, scale):
        return (loc + rng.normal(0, scale, a.shape)).astype(a.dtype)

    blocks = []
    for blk in tree["blocks"]:
        blk = dict(blk)
        for k in ("bq", "bk", "bv"):
            if k in blk:
                blk[k] = draw(blk[k], 0.0, 0.5)
        for k in ("q_norm", "k_norm"):
            if k in blk:
                blk[k] = draw(blk[k], 1.0, 0.3)
        blocks.append(blk)
    out = dict(tree, blocks=tuple(blocks))
    if "img_proj" in out:
        d = out["img_proj"].shape[0]
        out["img_proj"] = draw(out["img_proj"], 0.0, d ** -0.5)
    return out


@functools.lru_cache(maxsize=None)
def smoke_model(name):
    """(jcfg, cfg, numpy tree) of a smoke config at f32: the reference's
    weights with :func:`randomized` biases, norms and ``img_proj``."""
    jcfg = jax_get_smoke(name).replace(dtype=jnp.float32)
    cfg = get_smoke(name).replace(dtype=torch.float32)
    tree = randomized(jax.tree.map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(0), jcfg)))
    return jcfg, cfg, tree


def both(name, quant=False, pack=False, drop_float=False):
    """(jcfg, jparams, cfg, params): the same weights in both frameworks
    (a fresh port tree each call: ``drop_float`` rewrites its input)."""
    jcfg, cfg, tree = smoke_model(name)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(cfg, tree, device="cpu")
    if quant:
        jparams = jax_quantize(jcfg, jparams, pack=pack,
                               drop_float=drop_float)
        params = quantize_model_params(cfg, params, pack=pack,
                                       drop_float=drop_float)
    return jcfg, jparams, cfg, params


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {f: _shapes(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (tuple, list)):
        return [_shapes(v) for v in tree]
    if tree is None:
        return None
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


# ---------------------------------------------------------------------------
# configurations and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jax_list_archs())
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_config_copied_field_for_field(name, which):
    get, jget = ((get_config, jax_get_config) if which == "config"
                 else (get_smoke, jax_get_smoke))
    cfg, jcfg = get(name), jget(name)
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name in ("dtype", "cache_dtype"):
            a = None if a is None else str(a).split(".")[-1]
            b = None if b is None else jnp.dtype(b).name
        assert a == b, f.name
    assert cfg.repeats == jcfg.repeats


def test_registry_has_every_reference_alias():
    assert list_archs() == jax_list_archs()
    for alias, mod in JAX_ALIASES.items():
        assert ALIASES[alias] == mod
        assert get_config(alias).name == jax_get_config(alias).name
    with pytest.raises(KeyError):
        get_config("llama-70b")


@pytest.mark.parametrize("name", NEW)
def test_param_count_matches_reference(name):
    assert model.param_count(get_config(name)) == \
        jax_model.param_count(jax_get_config(name))


@pytest.mark.parametrize("variant", ["float", "quant", "packed", "drop"])
@pytest.mark.parametrize("name", jax_list_archs())
def test_params_tree_matches_reference(name, variant):
    """init_params, then quantize_model_params unpacked, packed and with
    ``drop_float`` (packed), leaf for leaf in shape and dtype."""
    jcfg = jax_get_smoke(name).replace(dtype=jnp.float32)
    cfg = get_smoke(name).replace(dtype=torch.float32)
    kw = {"float": None, "quant": dict(), "packed": dict(pack=True),
          "drop": dict(pack=True, drop_float=True)}[variant]

    def ref(k):
        p = jax_model.init_params(k, jcfg)
        return p if kw is None else jax_quantize(jcfg, p, **kw)

    p = model.init_params(cfg, device="cpu")
    if kw is not None:
        p = quantize_model_params(cfg, p, **kw)
    assert _shapes(p) == _shapes(jax.eval_shape(ref, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name", ["qwen3_32b", "qwen25_14b",
                                  "internvl2_26b"])
def test_params_from_numpy_carries_the_new_leaves(name):
    """bq/bk/bv, q_norm/k_norm, img_proj and the (R, 1) placeholders of a
    dropped tree arrive bit for bit."""
    jcfg, jparams, cfg, params = both(name, quant=True, pack=True,
                                      drop_float=True)
    moved = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    blk, jblk = moved["blocks"][0], jparams["blocks"][0]
    keys = [k for k in ("bq", "bk", "bv", "q_norm", "k_norm", "wq", "gate")
            if k in blk or k in blk.get("mlp", {})]
    for k in keys:
        got = blk[k] if k in blk else blk["mlp"][k]
        want = jblk[k] if k in jblk else jblk["mlp"][k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert blk["wq"].shape == (cfg.repeats, 1)
    if cfg.frontend == "vision_stub":
        np.testing.assert_array_equal(moved["img_proj"].numpy(),
                                      np.asarray(jparams["img_proj"]))


# ---------------------------------------------------------------------------
# dense with a bias, attention with qk_norm / qkv_bias
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_dense_with_bias_matches_reference(quant):
    """Float and quantized projection plus bias, bit for bit: the int32
    GEMM is exact and the epilogue repeats the reference's order."""
    from repro.core.shiftadd import quantized_linear_init as jax_qinit
    from repro_torch.core.shiftadd import quantized_linear_init

    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.2, (48, 40)).astype(np.float32)
    b = rng.normal(0, 0.5, (40,)).astype(np.float32)
    x = rng.normal(0, 1, (2, 5, 48)).astype(np.float32)
    jq = jax_qinit(jnp.asarray(w)) if quant else None
    q = quantized_linear_init(torch.from_numpy(w)) if quant else None
    want = jax_layers.dense(jnp.asarray(w), jnp.asarray(x), jnp.asarray(b),
                            jq, ctx="xla" if quant else None)
    got = layers.dense(torch.from_numpy(w), torch.from_numpy(x),
                       torch.from_numpy(b), q, ctx=quant)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    no_bias = layers.dense(torch.from_numpy(w), torch.from_numpy(x),
                           quant=q, ctx=quant)
    assert not torch.equal(no_bias, got)


def _pools(jcfg, cfg, cache, b, s):
    """Both frameworks' empty caches of one kind, and the page table
    (None for the dense cache)."""
    if cache == "dense":
        return (jax_model.init_caches(jcfg, b, s + 2, dtype=jcfg.dtype),
                model.init_caches(cfg, b, s + 2, dtype=cfg.dtype,
                                  device="cpu"), None)
    page_len, nb = 4, 4
    n_pages = 1 + b * nb
    table = (1 + np.arange(b * nb, dtype=np.int32)).reshape(b, nb)
    return (jax_model.init_paged_pool(jcfg, b, nb * page_len, n_pages,
                                      page_len),
            model.init_paged_pool(cfg, b, nb * page_len, n_pages, page_len,
                                  device="cpu"), table)


CACHES = {"dense": {}, "paged": {},
          "paged_kernel": dict(paged_attn_kernel="pallas",
                               paged_attn_splits=2),
          "kv_quant": dict(kv_quant=True, kv_bits=4)}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("name", ["qwen3_32b", "qwen25_14b"])
def test_prefill_decode_logits_match_reference(name, cache):
    """Prefill 8 tokens, then two decode steps, on the dense cache, the
    paged pool read by the gather and by the paged-attention kernel's
    plain version (splits 2), and the log2-quantized pool."""
    jcfg, jparams, cfg, params = both(name)
    jcfg, cfg = jcfg.replace(**CACHES[cache]), cfg.replace(**CACHES[cache])
    b, s = 2, 8
    jc, c, table = _pools(jcfg, cfg, cache, b, s)
    jt = None if table is None else jnp.asarray(table)
    tt = None if table is None else torch.from_numpy(table)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    for step in range(3):
        jl, jc = jax_model.forward(jcfg, jparams, tokens=jnp.asarray(toks),
                                   caches=jc, page_table=jt)
        tl, c = model.forward(cfg, params, tokens=torch.from_numpy(toks),
                              caches=c, page_table=tt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {step}")
        toks = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)


# ---------------------------------------------------------------------------
# one-shot serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant,pack", [(False, False), (True, False),
                                        (True, True)])
@pytest.mark.parametrize("name", DENSE)
def test_greedy_tokens_match_reference(name, quant, pack):
    jcfg, jparams, cfg, params = both(name, quant, pack)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jt, js = jax_engine.greedy_generate(
        jcfg, jparams, jnp.asarray(prompt), 6,
        quant="xla" if quant else False, with_stats=True)
    t, st = engine.greedy_generate(cfg, params, torch.from_numpy(prompt), 6,
                                   quant=quant, with_stats=True,
                                   device="cpu")
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    for key in ("plane_traffic_fraction", "element_traffic_fraction"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(js[key]),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the scheduler, tick by tick
# ---------------------------------------------------------------------------

K3 = dict(PAGED, attn_kernel="pallas", attn_splits=2)
QUANT_STATS = dict(K3, quant="xla", with_stats=True)
SCHED_MODES = {
    # tests/test_paged_attention.py's qwen3 GQA case
    "qwen3_paged_k3": ("qwen3_32b", K3, False),
    # tests/test_kv_quant.py's qwen3 GQA case
    "qwen3_kv_quant_k4": ("qwen3_32b", dict(K3, kv_quant=True, page_len=8),
                          False),
    "qwen25_paged_k3": ("qwen25_14b", K3, False),
}


def _run(name, kw, quant, drop_float=False, reference=True):
    """(the reference's drive or None, the port's, the port's scheduler)
    over ``_prompts()``, 6 new tokens each."""
    jcfg, jparams, cfg, params = both(name, quant, drop_float=drop_float)
    ref = _drive(JaxScheduler(jcfg, jparams, JaxServeConfig(**kw)),
                 _prompts(), 6) if reference else None
    sched = ServeScheduler(cfg, params, ServeConfig(**kw), device="cpu")
    return ref, _drive(sched, _prompts(), 6), sched


@pytest.mark.parametrize("mode", list(SCHED_MODES))
def test_scheduler_matches_reference(mode):
    name, kw, quant = SCHED_MODES[mode]
    ref, ours, sched = _run(name, kw, quant)
    _compare(ref, ours)
    results = ours[2]
    assert len(results) == 8
    assert all(len(r.tokens) == 6 for r in results)
    assert sched.prefix_cache_stats()["lookup_hits"] >= 2
    if quant:
        assert all(0 < r.plane_traffic_fraction <= 1 for r in results)


def test_quantized_scheduler_matches_reference_but_for_code_flips():
    """qwen2.5 smoke quantized with stats (K3's plain version, prefix
    cache): every tick's lengths, page tables, refcounts, free list and
    prefix-cache stats, and every request's finish reason and ticks equal
    the reference's; tokens and traffic fractions are not held.  At f32
    the attention output that feeds ``wo``'s LOG2 quantizer differs from
    XLA's by float rounding (other summation orders), and an element
    within that rounding of a code boundary takes the other code: with
    these weights the bucketed prefill of request 2 meets one at layer 2
    (input |diff| 4.8e-7, ``wo`` output |diff| 0.37), which changes its
    tokens.  Equal tokens on the quantized path hold for given inputs,
    not for every input (ROADMAP queue 3)."""
    ref, ours, _ = _run("qwen25_14b", QUANT_STATS, True)
    (jrids, jlog, jres), (rids, log, res) = ref, ours
    assert rids == jrids and log == jlog
    shape = [(r.rid, r.prompt_len, len(r.tokens), r.finish_reason,
              r.admitted_tick, r.finished_tick) for r in res]
    assert shape == [(r.rid, r.prompt_len, len(r.tokens), r.finish_reason,
                      r.admitted_tick, r.finished_tick) for r in jres]
    assert all(0 < r.plane_traffic_fraction <= 1 for r in res)


# ---------------------------------------------------------------------------
# drop_float
# ---------------------------------------------------------------------------

def test_drop_float_one_shot_equals_floats_kept_and_reference():
    """Packed planes alone give the tokens and plane stats of the tree
    that keeps its floats, and the reference's dropped tree's tokens."""
    runs = []
    for drop in (False, True):
        jcfg, jparams, cfg, params = both("qwen3_32b", True, True, drop)
        prompt = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int32))
        runs.append(engine.greedy_generate(cfg, params, prompt, 6, quant=True,
                                           with_stats=True, device="cpu"))
    (t0, s0), (t1, s1) = runs
    assert torch.equal(t0, t1)
    for key in s0:
        assert torch.equal(s0[key], s1[key]), key
    jt = jax_engine.greedy_generate(jcfg, jparams, jnp.asarray(prompt), 6,
                                    quant="xla")
    np.testing.assert_array_equal(t1.numpy(), np.asarray(jt))


def test_drop_float_scheduler_equals_floats_kept():
    """The scheduler (paged, prefix cache, K3's plain version, quantized
    with stats) on a dropped tree: the ticks, tokens and stats of the
    tree that keeps its floats."""
    _, kept, _ = _run("qwen3_32b", QUANT_STATS, True, reference=False)
    _, dropped, _ = _run("qwen3_32b", QUANT_STATS, True, drop_float=True,
                         reference=False)
    _compare(kept, dropped)
    for a, b in zip(kept[2], dropped[2]):
        assert a.plane_traffic_fraction == b.plane_traffic_fraction
        assert a.element_traffic_fraction == b.element_traffic_fraction


def test_drop_float_frees_the_callers_float_leaves():
    """With ``drop_float`` the caller's projection leaves, shared experts
    included, become the (R, 1) placeholder; norms, biases, embeddings,
    routers and routed experts stay; without it the input is untouched."""
    _, _, cfg, params = both("qwen25_14b")
    kept = quantize_model_params(cfg, params)
    blk = params["blocks"][0]
    wq = blk["wq"]
    assert kept["blocks"][0]["wq"] is wq and blk["wq"] is wq
    out = quantize_model_params(cfg, params, drop_float=True)
    for tree in (params, out):
        b0 = tree["blocks"][0]
        for leaf in [b0[k] for k in ("wq", "wk", "wv", "wo")] + \
                [b0["mlp"][k] for k in ("gate", "up", "down")]:
            assert leaf.shape == (cfg.repeats, 1) and not leaf.any()
        assert b0["bq"].shape == (cfg.repeats, cfg.n_heads * cfg.head_dim)
        assert tree["embed"].shape == (cfg.vocab_size, cfg.d_model)
    assert "wq_q" in out["blocks"][0] and "wq_q" not in blk

    mcfg = get_smoke("deepseek-moe-16b").replace(dtype=torch.float32)
    mp = model.init_params(mcfg, device="cpu")
    mq = quantize_model_params(mcfg, mp, pack=True, drop_float=True)
    for tree in (mp, mq):
        mlp = tree["blocks"][0]["mlp"]
        assert mlp["shared"]["gate"].shape == (mcfg.repeats, 1)
        assert mlp["experts"]["gate"].dim() == 4
        assert mlp["router"].dtype == torch.float32


def test_float_forward_on_a_dropped_tree_raises():
    _, _, cfg, params = both("qwen3_32b", True, True, drop_float=True)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="dropped"):
        model.forward(cfg, params, tokens=toks)
    logits, _ = model.forward(cfg, params, tokens=toks, quant=True)
    assert bool(torch.isfinite(logits).all())
