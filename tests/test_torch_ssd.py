"""The port's Mamba-2 SSD path (``repro_torch.models.ssd`` and the mamba
blocks of ``repro_torch.models.model``) held against the JAX package's on
the mamba2-780m smoke config at f32: the same inputs from a numpy seed,
the reference's weights carried across by ``params_from_numpy``.

Module level, within ``rtol=1e-5, atol=1e-6``: ``ssd_chunked`` with and
without an initial state, with a sequence that is and one that is not a
multiple of the chunk; ``_causal_conv``; ``_window_at`` (exact); and
``mamba2_block`` in its three branches (stateless, stateful chunked,
unrolled recurrence) with ``valid_len`` masking, where a row with
``valid_len == 0`` keeps its state and window bit for bit.  Model level:
``forward`` logits float and quantized within ``rtol=1e-4, atol=1e-5``
(48-head-dim f32 sums over 4 layers in other orders than XLA's; every
quantized GEMM is exact), plane-traffic fractions within 1e-6, and
``greedy_generate`` tokens equal, float, quantized and quantized on packed
planes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.models import model as jax_model
from repro.models import ssd as jax_ssd
from repro.models.quantize import quantize_model_params as jax_quantize
from repro.serving import engine as jax_engine
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import model, ssd
from repro_torch.models.convert import params_from_numpy, pool_from_numpy
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import engine

MOD_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_smoke("mamba2_780m").replace(dtype=jnp.float32)
    cfg = get_smoke("mamba2-780m").replace(dtype=torch.float32)
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def qsetup(setup):
    jcfg, cfg, jparams, params = setup
    return {pack: (jax_quantize(jcfg, jparams, pack=pack),
                   quantize_model_params(cfg, params, pack=pack))
            for pack in (False, True)}


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# configuration, parameters, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "smoke"])
def test_config_copied_field_for_field(which):
    get, jget = ((get_config, jax_get_config) if which == "config"
                 else (get_smoke, jax_get_smoke))
    cfg, jcfg = get("mamba2-780m"), jget("mamba2-780m")
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name in ("dtype", "cache_dtype"):
            a = None if a is None else str(a).split(".")[-1]
            b = None if b is None else jnp.dtype(b).name
        assert a == b, f.name
    assert cfg.d_inner == jcfg.d_inner


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return [_shapes(v) for v in tree]
    if hasattr(tree, "_fields"):
        return {f: _shapes(getattr(tree, f)) for f in tree._fields}
    if tree is None:
        return None
    dt = str(tree.dtype).split(".")[-1]
    return (tuple(tree.shape), dt)


@pytest.mark.parametrize("pattern,d_ff", [(("mamba",), 0),
                                          (("mamba", "attn"), 64)])
def test_params_and_caches_match_reference_layout(pattern, d_ff):
    """init_params, quantize_model_params, init_caches and init_paged_pool
    give the reference's tree: the same keys, shapes and dtypes (a mamba
    block has an MLP only when d_ff is set)."""
    kw = dict(pattern=pattern, d_ff=d_ff, n_heads=2, n_kv_heads=1,
              head_dim=16, dtype=jnp.float32)
    jcfg = jax_get_smoke("mamba2_780m").replace(**kw)
    cfg = get_smoke("mamba2-780m").replace(**dict(kw, dtype=torch.float32))
    jp = jax.eval_shape(lambda k: jax_model.init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    p = model.init_params(cfg, device="cpu")
    assert _shapes(p) == _shapes(jp)
    for pack in (False, True):
        assert _shapes(quantize_model_params(cfg, p, pack=pack)) == \
            _shapes(jax.eval_shape(lambda t: jax_quantize(jcfg, t, pack=pack),
                                   jp))
    jc = jax.eval_shape(lambda: jax_model.init_caches(jcfg, 3, 16,
                                                      per_slot=True))
    c = model.init_caches(cfg, 3, 16, device="cpu", per_slot=True)
    assert _shapes(c) == _shapes(jc)
    for kv_quant in (False, True):
        jpool = jax.eval_shape(lambda: jax_model.init_paged_pool(
            jcfg.replace(kv_quant=kv_quant), 3, 16, 9, 4))
        pool = model.init_paged_pool(cfg.replace(kv_quant=kv_quant), 3, 16,
                                     9, 4, device="cpu")
        assert _shapes(pool) == _shapes(jpool)


def test_unported_kinds_raise():
    """A block kind outside ``PORTED_KINDS`` (the ``*_moe`` kinds are
    served since the MoE slice) raises."""
    cfg = get_smoke("mamba2-780m").replace(pattern=("mamba_conv",))
    with pytest.raises(NotImplementedError, match="mamba_conv"):
        model.init_params(cfg, device="cpu")


# ---------------------------------------------------------------------------
# module level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [32, 21])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(s, with_state):
    rng = np.random.default_rng(s + 10 * with_state)
    b, h, p, n, chunk = 2, 3, 8, 5, 8
    x = _rand(rng, b, s, h, p)
    a = -np.abs(_rand(rng, b, s, h, scale=0.5))
    bb, cc = _rand(rng, b, s, n), _rand(rng, b, s, n)
    st = _rand(rng, b, h, p, n) if with_state else None
    jy, jf = jax_ssd.ssd_chunked(*map(jnp.asarray, (x, a, bb, cc)), chunk,
                                 init_state=None if st is None
                                 else jnp.asarray(st))
    y, f = ssd.ssd_chunked(*map(torch.from_numpy, (x, a, bb, cc)), chunk,
                           init_state=None if st is None
                           else torch.from_numpy(st))
    assert y.shape == (b, s, h, p) and f.shape == (b, h, p, n)
    np.testing.assert_allclose(_np(y), _np(jy), **MOD_TOL)
    np.testing.assert_allclose(_np(f), _np(jf), **MOD_TOL)


def test_causal_conv_and_segsum_match_reference():
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 2, 11, 12), _rand(rng, 4, 12), _rand(rng, 12)
    np.testing.assert_allclose(
        _np(ssd._causal_conv(*map(torch.from_numpy, (x, w, b)))),
        _np(jax_ssd._causal_conv(*map(jnp.asarray, (x, w, b)))), **MOD_TOL)
    a = _rand(rng, 2, 3, 6)
    np.testing.assert_allclose(_np(ssd._segsum(torch.from_numpy(a))),
                               _np(jax_ssd._segsum(jnp.asarray(a))),
                               **MOD_TOL)


def test_window_at_matches_reference():
    rng = np.random.default_rng(2)
    window = _rand(rng, 4, 3 + 7, 5)
    valid = np.asarray([0, 3, 7, 1], np.int32)
    got = ssd._window_at(torch.from_numpy(window), torch.from_numpy(valid), 4)
    want = jax_ssd._window_at(jnp.asarray(window), jnp.asarray(valid), 4)
    np.testing.assert_array_equal(_np(got), _np(want))


def _block_inputs(setup, s, seed):
    jcfg, cfg, jparams, params = setup
    jp = jax.tree.map(lambda t: t[1], jparams["blocks"][0])
    p = model._layer(params["blocks"][0], 1)
    rng = np.random.default_rng(seed)
    b = 3
    x = _rand(rng, b, s, cfg.d_model)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    ssm = _rand(rng, b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                scale=0.3)
    conv = _rand(rng, b, cfg.conv_width - 1, conv_dim)
    return jp, p, x, ssm, conv


@pytest.mark.parametrize("branch,s", [("stateless", 9), ("chunked", 9),
                                      ("chunked", 21), ("unrolled", 1),
                                      ("unrolled", 4)])
@pytest.mark.parametrize("masked", [False, True])
def test_mamba2_block_matches_reference(setup, branch, s, masked):
    """Each branch of the block, with and without ``valid_len`` (rows of
    0, some and all real tokens); with a state, a ``valid_len == 0`` row
    keeps state and window bit-identical."""
    jcfg, cfg, _, _ = setup
    jp, p, x, ssm, conv = _block_inputs(setup, s, seed=s + 3 * masked)
    valid = (np.asarray([0, min(2, s), s], np.int32) if masked else None)
    jstate = st = None
    if branch != "stateless":
        jstate = jax_ssd.SSMState(ssm=jnp.asarray(ssm), conv=jnp.asarray(conv))
        st = ssd.SSMState(ssm=torch.from_numpy(ssm),
                          conv=torch.from_numpy(conv))
    jout, jnew = jax_ssd.mamba2_block(
        jp, jnp.asarray(x), jcfg, state=jstate,
        valid_len=None if valid is None else jnp.asarray(valid))
    out, new = ssd.mamba2_block(
        p, torch.from_numpy(x), cfg, state=st,
        valid_len=None if valid is None else torch.from_numpy(valid))
    live = slice(None) if valid is None else valid > 0
    np.testing.assert_allclose(_np(out)[live], _np(jout)[live], **MOD_TOL)
    if branch == "stateless":
        assert new is None and jnew is None
        return
    np.testing.assert_allclose(_np(new.ssm), _np(jnew.ssm), **MOD_TOL)
    np.testing.assert_allclose(_np(new.conv), _np(jnew.conv), **MOD_TOL)
    if masked:
        assert torch.equal(new.ssm[0], st.ssm[0])
        assert torch.equal(new.conv[0], st.conv[0])


def test_write_rows_selects_in_place():
    dst = torch.arange(12.0).reshape(3, 2, 2)
    ptr = dst.data_ptr()
    src = -torch.ones((3, 2, 2))
    ssd.write_rows_(dst, src, torch.tensor([True, False, True]))
    assert dst.data_ptr() == ptr
    assert torch.equal(dst[1], torch.arange(4.0, 8.0).reshape(2, 2))
    assert (dst[0] == -1).all() and (dst[2] == -1).all()
    ssd.write_rows_(dst, src)
    assert (dst == -1).all()


# ---------------------------------------------------------------------------
# model level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_forward_logits_match_reference(setup, qsetup, quant):
    """No cache, then a prefill of 9 tokens (chunked dual form) into a
    cache and two decode steps (the recurrence), with stats: logits within
    tolerance, the state the port wrote in place within tolerance of the
    reference's, traffic fractions within 1e-6."""
    jcfg, cfg, jparams, params = setup
    if quant:
        jparams, params = qsetup[False]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    jl, _ = jax_model.forward(jcfg, jparams, tokens=jnp.asarray(toks[:, :9]),
                              quant=quant)
    tl, _ = model.forward(cfg, params, tokens=torch.from_numpy(toks[:, :9]),
                          quant=quant)
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    jc = jax_model.init_caches(jcfg, 2, 16)
    c = model.init_caches(cfg, 2, 16, device="cpu")
    for lo, hi in ((0, 9), (9, 10), (10, 11)):
        jl, jc, js = jax_model.forward(
            jcfg, jparams, tokens=jnp.asarray(toks[:, lo:hi]), caches=jc,
            quant=quant, return_stats=True)
        tl, c, ts = model.forward(cfg, params,
                                  tokens=torch.from_numpy(toks[:, lo:hi]),
                                  caches=c, quant=quant, return_stats=True)
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(_np(c["layers"][0][k]),
                                       _np(jc["layers"][0][k]), **LOGIT_TOL)
        for k in ("plane_traffic_fraction", "element_traffic_fraction"):
            assert abs(float(ts[k]) - float(js[k])) <= 1e-6, k
        if quant:
            assert 0 < float(ts["plane_traffic_fraction"]) <= 1
    assert c["length"] == 11


def test_pool_from_numpy_carries_ssm_leaves(setup):
    jcfg, cfg, _, _ = setup
    jpool = jax_model.init_paged_pool(jcfg, 2, 16, 5, 4)
    jpool = jax.tree.map(lambda t: t + 1 if t.dtype == jnp.float32 else t,
                         jpool)
    pool = pool_from_numpy(jax.tree.map(np.asarray, jpool), device="cpu")
    for k in ("ssm", "conv"):
        np.testing.assert_array_equal(_np(pool["layers"][0][k]),
                                      _np(jpool["layers"][0][k]))


@pytest.mark.parametrize("quant,pack", [(False, False), (True, False),
                                        (True, True)])
def test_greedy_generate_tokens_match_reference(setup, qsetup, quant, pack):
    jcfg, cfg, jparams, params = setup
    if quant:
        jparams, params = qsetup[pack]
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    jt = jax_engine.greedy_generate(jcfg, jparams, jnp.asarray(prompt), 6,
                                    quant="xla" if quant else False)
    t = engine.greedy_generate(cfg, params, torch.from_numpy(prompt), 6,
                               quant=quant, device="cpu")
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    ref = engine.reference_generate(cfg, params, torch.from_numpy(prompt), 6,
                                    quant=quant, device="cpu")
    np.testing.assert_array_equal(t.numpy(), ref.numpy())
