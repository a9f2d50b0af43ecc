"""The port's dense decoder (``repro_torch.models``) held against the JAX
package's on the smoke config at f32, with the reference's weights carried
across by ``params_from_numpy``.

Float logits agree within rtol = atol = 1e-5 (XLA and ATen sum in other
orders; the largest difference measured on the CPU was 5.5e-7, and the
margin covers other CPUs and XLA builds); quantized logits too, because
every projection's int32 GEMM is exact and the float epilogue repeats the
reference's operation order.
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
from repro.models.quantize import quantize_model_params as jax_quantize
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.shiftadd import QuantizedLinearParams
from repro_torch.models import model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.quantize import quantize_model_params

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_smoke("smollm_135m").replace(dtype=jnp.float32)
    cfg = get_smoke("smollm-135m").replace(dtype=torch.float32)
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                         jcfg.vocab_size))
    return jcfg, cfg, jparams, params, tokens


def _leaves(tree, prefix=""):
    """Flatten a params tree to {path: array} for both frameworks."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_leaves(getattr(tree, f), f"{prefix}.{f}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}[{i}]"))
        return out
    if isinstance(tree, jax.ShapeDtypeStruct):
        return {prefix: np.zeros(tree.shape, np.float32)}
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return {prefix: tree.float().numpy()}
        return {prefix: tree.numpy()}
    return {prefix: np.asarray(tree, np.float32)
            if np.asarray(tree).dtype == jnp.bfloat16 else np.asarray(tree)}


@pytest.mark.parametrize("which", ["config", "smoke"])
def test_config_copied_field_for_field(which):
    cfg = get_config("smollm-135m") if which == "config" else \
        get_smoke("smollm_135m")
    jcfg = jax_get_config("smollm-135m") if which == "config" else \
        jax_get_smoke("smollm_135m")
    for f in dataclasses.fields(cfg):
        mine, ref = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "dtype":
            assert str(mine).split(".")[-1] == jnp.dtype(ref).name
        else:
            assert mine == ref, f.name
    assert cfg.repeats == jcfg.repeats
    with pytest.raises(KeyError):
        get_config("llama-70b")


def test_init_params_and_caches_have_reference_layout():
    cfg = get_smoke("smollm-135m")
    jcfg = jax_get_smoke("smollm_135m")
    shapes = jax.eval_shape(lambda k: jax_model.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    mine = model.init_params(cfg, generator=torch.Generator().manual_seed(3),
                             device="cpu")
    ref = {k: v for k, v in _leaves(shapes).items()}
    got = _leaves(mine)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].shape == v.shape, k
    assert all(t.dtype == torch.bfloat16 for t in
               (mine["embed"], mine["blocks"][0]["wq"],
                mine["blocks"][0]["mlp"]["down"]))
    again = model.init_params(cfg, generator=torch.Generator().manual_seed(3),
                              device="cpu")
    assert torch.equal(again["embed"], mine["embed"])
    caches = model.init_caches(cfg, 2, 12, device="cpu")
    jc = jax.eval_shape(lambda: jax_model.init_caches(jcfg, 2, 12))
    assert caches["layers"][0]["k"].shape == jc["layers"][0]["k"].shape
    assert caches["length"] == 0


def test_params_from_numpy_round_trip(setup):
    jcfg, cfg, jparams, params, _ = setup
    ref = _leaves(jax.tree.map(np.asarray, jparams))
    got = _leaves(params)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    # bf16 leaves keep their bits
    jb = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                      {"w": jparams["embed"][:4]})
    tb = params_from_numpy(cfg, jb, device="cpu")["w"]
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().numpy(),
                                  np.asarray(jb["w"], np.float32))


@pytest.mark.parametrize("pack", [False, True])
def test_quantize_model_params_bit_equal(setup, pack):
    jcfg, cfg, jparams, params, _ = setup
    qj = _leaves(jax.tree.map(np.asarray,
                              jax_quantize(jcfg, jparams, pack=pack)))
    q = quantize_model_params(cfg, params, pack=pack)
    got = _leaves(q)
    assert set(got) == set(qj)
    for k in qj:
        np.testing.assert_array_equal(got[k], qj[k], err_msg=k)
    wq = q["blocks"][0]["wq_q"]
    assert isinstance(wq, QuantizedLinearParams)
    assert wq.planes.dtype == torch.uint8
    assert wq.planes.shape[:2] == (cfg.repeats, 8)


def _run_both(setup, quant: bool):
    """Prefill 8 tokens then decode one, in both frameworks, with stats."""
    jcfg, cfg, jparams, params, tokens = setup
    if quant:
        jparams = jax_quantize(jcfg, jparams)
        params = quantize_model_params(cfg, params)
    jq = "xla" if quant else False
    b, s = tokens.shape
    jc = jax_model.init_caches(jcfg, b, s + 1, dtype=jcfg.dtype)
    jl, jc, js = jax_model.forward(jcfg, jparams, tokens=jnp.asarray(tokens),
                                   caches=jc, quant=jq, return_stats=True)
    nxt = np.array(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl2, _, js2 = jax_model.forward(jcfg, jparams, tokens=jnp.asarray(nxt),
                                    caches=jc, quant=jq, return_stats=True)
    c = model.init_caches(cfg, b, s + 1, dtype=cfg.dtype, device="cpu")
    l, c, st = model.forward(cfg, params, tokens=torch.from_numpy(tokens),
                             caches=c, quant=quant, return_stats=True)
    l2, c2, st2 = model.forward(cfg, params, tokens=torch.from_numpy(nxt),
                                caches=c, quant=quant, return_stats=True)
    assert c2["length"] == s + 1
    return (jl, js, jl2, js2), (l, st, l2, st2)


@pytest.mark.parametrize("quant", [False, True])
def test_forward_logits_and_stats_match_reference(setup, quant):
    (jl, js, jl2, js2), (l, st, l2, st2) = _run_both(setup, quant)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), rtol=RTOL,
                               atol=ATOL)
    for a, b in ((st, js), (st2, js2)):
        for key in ("plane_fetched", "plane_total", "plane_traffic_fraction",
                    "element_traffic_fraction"):
            assert abs(float(a[key]) - float(b[key])) <= 1e-6, key
    if quant:
        assert 0 < float(st2["plane_traffic_fraction"]) <= 1
    else:
        assert float(st["plane_total"]) == 0.0


def test_forward_without_cache_matches_reference(setup):
    jcfg, cfg, jparams, params, tokens = setup
    jl, _ = jax_model.forward(jcfg, jparams, tokens=jnp.asarray(tokens))
    l, caches = model.forward(cfg, params, tokens=torch.from_numpy(tokens))
    assert caches is None
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


def test_flash_attention_chunks_and_padding_match_reference():
    """Prefill attention over several KV chunks with a ragged last chunk
    (the smoke config's prompts fit in one)."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention
    rng = np.random.default_rng(4)
    b, s, h, g, d = 2, 37, 6, 2, 16
    q, k, v = (rng.normal(0, 1, (b, s, n, d)).astype(np.float32)
               for n in (h, g, g))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    for chunk in (8, 16, 64):
        want = jax_attn.flash_attention(*(jnp.asarray(a) for a in
                                          (q, k, v, pos, pos)),
                                        kv_chunk=chunk)
        got = attention.flash_attention(*(torch.from_numpy(a) for a in
                                          (q, k, v, pos, pos)),
                                        kv_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
