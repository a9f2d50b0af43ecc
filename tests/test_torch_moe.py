"""The port's Mixture-of-Experts path (``repro_torch.models.moe`` and the
``attn_moe`` / ``mamba_moe`` blocks of ``repro_torch.models.model``) held
against the JAX package's local path on the deepseek-moe, jamba and
phi3.5-moe smoke configs at f32: the same inputs from a numpy seed, the
reference's weights carried across by ``params_from_numpy``.

Exact: routing ids (ties, an all-zero row among them, go to the lower
expert index), the dispatch tables ``order``/``dest``/``keep`` on random
and adversarial ids, the combine against ``jnp.zeros(...).at[idx].add``
at f32 on values spanning 12 decades and at bf16, the dispatch tables of
every ``moe_apply`` call, ``param_count`` and the quantized tree's
planes.  Gates within 1 ulp.  ``moe_apply`` within ``rtol=1e-4,
atol=1e-5`` (XLA and ATen sum the expert products in other orders; every
quantized GEMM is exact), float and quantized (the shared experts through
QeiHaN), at the default ``capacity_factor`` (slots are dropped) and at 100
(none are).  ``greedy_generate`` tokens equal at the default capacity,
where the prefill and the decode steps drop slots.  ``forward`` and the
decode are held in ``tests/test_torch_moe_model.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models.quantize import quantize_model_params as jax_quantize
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import model, moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.quantize import quantize_model_params

ARCHS = ["deepseek_moe_16b", "jamba_v01_52b", "phi35_moe_42b"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def smoke_model(name):
    """(jcfg, cfg, jparams, params, jparams quantized, params quantized)
    of a smoke config at f32, the reference's weights in both."""
    jcfg = jax_get_smoke(name).replace(dtype=jnp.float32)
    cfg = get_smoke(name).replace(dtype=torch.float32)
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return (jcfg, cfg, jparams, params, jax_quantize(jcfg, jparams),
            quantize_model_params(cfg, params))


def count_drops(monkeypatch) -> list:
    """Patch ``moe._dispatch_tables`` to append each routed call's
    dropped-slot count to the returned list."""
    tables = moe._dispatch_tables
    dropped = []

    def counting(ids, n_experts, capacity):
        order, dest, keep = tables(ids, n_experts, capacity)
        dropped.append(int((~keep).sum()))
        return order, dest, keep

    monkeypatch.setattr(moe, "_dispatch_tables", counting)
    return dropped


def _moe_block(cfg):
    """The pattern position of the first ``*_moe`` block."""
    return next(i for i, k in enumerate(cfg.pattern) if k.endswith("_moe"))


# ---------------------------------------------------------------------------
# configuration, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
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


@pytest.mark.parametrize("name", ARCHS + ["smollm_135m", "mamba2_780m"])
def test_param_count_matches_reference(name):
    assert model.param_count(get_config(name)) == \
        jax_model.param_count(jax_get_config(name))


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


@pytest.mark.parametrize("name", ARCHS)
def test_params_layout_and_quantized_tree_match_reference(name):
    """init_params and quantize_model_params (both plane layouts) give the
    reference's tree; the router (f32) and routed experts stay float
    with no ``*_q``, the shared experts' planes equal the reference's."""
    jcfg, cfg, jparams, params, _, _ = smoke_model(name)
    jp = jax.eval_shape(lambda k: jax_model.init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    assert _shapes(model.init_params(cfg, device="cpu")) == _shapes(jp)
    assert _shapes(params) == _shapes(jparams)
    for pack in (False, True):
        jq = jax_quantize(jcfg, jparams, pack=pack)
        q = quantize_model_params(cfg, params, pack=pack)
        assert _shapes(q) == _shapes(jq)
        mlp = q["blocks"][_moe_block(cfg)]["mlp"]
        jmlp = jq["blocks"][_moe_block(cfg)]["mlp"]
        assert mlp["router"].dtype == torch.float32
        assert set(mlp["experts"]) == {"gate", "up", "down"}
        assert not any(k.endswith("_q") for k in mlp)
        if "shared" in mlp:
            for p in ("gate", "up", "down"):
                np.testing.assert_array_equal(
                    mlp["shared"][p + "_q"].planes.numpy(),
                    np.asarray(jmlp["shared"][p + "_q"].planes))


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_numpy_carries_moe_leaves(name):
    _, cfg, jparams, params, jq, q = smoke_model(name)
    i = _moe_block(cfg)
    for tree, jtree in ((params, jparams), (q, jq)):
        mlp, jmlp = tree["blocks"][i]["mlp"], jtree["blocks"][i]["mlp"]
        np.testing.assert_array_equal(mlp["router"].numpy(),
                                      np.asarray(jmlp["router"]))
        for p in ("gate", "up", "down"):
            np.testing.assert_array_equal(mlp["experts"][p].numpy(),
                                          np.asarray(jmlp["experts"][p]))
    if "shared" in q["blocks"][i]["mlp"]:
        sq = q["blocks"][i]["mlp"]["shared"]["down_q"]
        jsq = jq["blocks"][i]["mlp"]["shared"]["down_q"]
        np.testing.assert_array_equal(sq.w_scale.numpy(),
                                      np.asarray(jsq.w_scale))


# ---------------------------------------------------------------------------
# routing, dispatch, combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inputs", ["dyadic", "normal"])
def test_topk_routing_matches_reference(inputs):
    """An all-zero row (every logit ties: experts 0..k-1), a router with
    duplicated columns (pairwise ties) and rows of random values: ids
    equal.  On dyadic inputs every logit is exact in any summation order,
    so the gates (the softmax alone) agree within 1 ulp; on normal inputs
    the f32 logits may differ in their last bits, gates within 1e-6."""
    rng = np.random.default_rng(0)
    e, k, d = 8, 3, 16
    if inputs == "dyadic":
        w = (rng.integers(-8, 9, size=(d, e)) / 8).astype(np.float32)
        x = (rng.integers(-8, 9, size=(200, d)) / 4).astype(np.float32)
    else:
        w = rng.standard_normal((d, e)).astype(np.float32)
        x = rng.standard_normal((200, d)).astype(np.float32)
    w[:, 5] = w[:, 2]
    w[:, 7] = w[:, 0]
    x[3] = 0.0
    jg, ji = jax_moe.topk_routing(jnp.asarray(w), jnp.asarray(x), e, k)
    tg, ti = moe.topk_routing(torch.from_numpy(w), torch.from_numpy(x), e, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti[3].numpy(), [0, 1, 2])
    if inputs == "dyadic":
        np.testing.assert_array_max_ulp(tg.numpy(), np.asarray(jg), maxulp=1)
    else:
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6)
    for row in range(len(x)):
        ids = ti[row].tolist()
        assert not (5 in ids and 2 not in ids) and \
            not (7 in ids and 0 not in ids)


@pytest.mark.parametrize("case", ["random", "one_expert", "capacity_1",
                                  "g_1", "empty_experts"])
def test_dispatch_tables_bit_equal(case):
    rng = np.random.default_rng(1)
    e, cap = 8, 3
    ids = {"random": rng.integers(0, e, size=60),
           "one_expert": np.full(24, 5),
           "capacity_1": rng.integers(0, e, size=30),
           "g_1": np.asarray([6]),
           "empty_experts": rng.choice([1, 6], size=20)}[case]
    cap = 1 if case in ("capacity_1", "g_1") else cap
    ids = ids.astype(np.int32)
    jt = jax_moe._dispatch_tables(jnp.asarray(ids), e, cap)
    tt = moe._dispatch_tables(torch.from_numpy(ids), e, cap)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_bit_equal_to_scatter_add(dtype):
    """Each token's k slot outputs, on values spanning 12 decades (so the
    order of the adds decides the bits), summed as XLA's scatter-add sums
    them."""
    rng = np.random.default_rng(2)
    g, k, e, d = 11, 6, 8, 24
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for _ in range(5):
        ids = rng.integers(0, e, size=g * k).astype(np.int32)
        vals = (rng.standard_normal((g * k, d))
                * 10.0 ** rng.integers(-6, 6, size=(g * k, d))
                ).astype(np.float32)
        order, _, _ = jax_moe._dispatch_tables(jnp.asarray(ids), e, g)
        slot_token = jnp.repeat(jnp.arange(g), k)
        jv = jnp.asarray(vals).astype(jdt)
        ref = jnp.zeros((g, d), jdt).at[slot_token[order]].add(jv)
        tv = torch.tensor(np.asarray(jv.astype(jnp.float32))).to(tdt)
        out = moe._combine(tv, torch.from_numpy(np.asarray(order)).long(),
                           g, k)
        assert out.dtype == tdt
        np.testing.assert_array_equal(_np(out), _np(ref))


# ---------------------------------------------------------------------------
# moe_apply and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("capacity_factor", [1.25, 100.0])
def test_moe_apply_matches_reference(name, quant, capacity_factor,
                                     monkeypatch):
    """The first MoE layer on 2x9 rows that lean to one direction (a
    shared row plus N(0, 0.3^2) noise, so many rows pick the same
    experts): the reference's and the port's dispatch tables on these rows
    equal, outputs within TOL; at the default capacity some slots are
    dropped, at 100 none."""
    jcfg, cfg, jparams, params, jq, q = smoke_model(name)
    jcfg = jcfg.replace(capacity_factor=capacity_factor)
    cfg = cfg.replace(capacity_factor=capacity_factor)
    if quant:
        jparams, params = jq, q
    i = _moe_block(cfg)
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"][i]["mlp"])
    p = model._layer(params["blocks"][i]["mlp"], 0)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(cfg.d_model)
         + 0.3 * rng.standard_normal((2, 9, cfg.d_model))).astype(np.float32)
    jy = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg, quant=quant)
    tables = moe._dispatch_tables
    counted = count_drops(monkeypatch)
    y = moe.moe_apply(p, torch.from_numpy(x), cfg, quant=quant)
    (dropped,) = counted
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)

    g, e, k = 18, cfg.n_experts, cfg.experts_per_token
    cap = min(int(g * k / e * capacity_factor) + 1, g)
    _, jids = jax_moe.topk_routing(jp["router"], jnp.asarray(x).reshape(g, -1),
                                   e, k)
    _, ids = moe.topk_routing(p["router"], torch.from_numpy(x).reshape(g, -1),
                              e, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    jt = jax_moe._dispatch_tables(jids.reshape(-1), e, cap)
    tt = tables(ids.reshape(-1), e, cap)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert dropped == int((~np.asarray(jt[2])).sum())
    assert (dropped > 0) == (capacity_factor < 2)


@pytest.mark.parametrize("name,quant", [(n, False) for n in ARCHS]
                         + [("deepseek_moe_16b", True)])
def test_greedy_generate_tokens_match_reference(name, quant, monkeypatch):
    """The one-shot program at the default capacity, where the prefill's
    2x7 rows and the decode steps' 2 drop slots: routing the same rows as
    the reference's prefill and decode gives its tokens."""
    from repro.serving import engine as jax_engine
    from repro_torch.serving import engine

    jcfg, cfg, jparams, params, jq, q = smoke_model(name)
    if quant:
        jparams, params = jq, q
    prompt = np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    jt = jax_engine.greedy_generate(jcfg, jparams, jnp.asarray(prompt), 6,
                                    quant="xla" if quant else False)
    dropped = count_drops(monkeypatch)
    t = engine.greedy_generate(cfg, params, torch.from_numpy(prompt), 6,
                               quant=quant, device="cpu")
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert sum(dropped) > 0
