"""The MoE blocks at the model level (``repro_torch.models.model`` on
the deepseek-moe, jamba and phi3.5-moe smoke configs at f32) held
against the JAX package: ``forward`` logits within ``rtol=1e-4,
atol=1e-5``, float and quantized (the shared experts through QeiHaN),
with plane-traffic fractions within 1e-6; decode one token at a time
equal to the full forward at ``capacity_factor=100``.  Weights and
helpers come from ``tests/test_torch_moe.py``, which also holds the
one-shot tokens.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jax_model
from repro_torch.models import model
from test_torch_moe import ARCHS, TOL, _np, smoke_model


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("quant", [False, True])
def test_forward_matches_reference_with_stats(name, quant):
    """Float: no cache, then a prefill of 9 tokens into a cache and two
    decode steps; quantized: the prefill and one decode step (the
    reference's eager quantized jamba forward takes about 12 s), with
    stats: logits within TOL, traffic fractions within 1e-6 (the shared
    experts' planes count; the routed experts are float)."""
    jcfg, cfg, jparams, params, jq, q = smoke_model(name)
    if quant:
        jparams, params = jq, q
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    if not quant:
        jl, _ = jax_model.forward(jcfg, jparams,
                                  tokens=jnp.asarray(toks[:, :9]))
        tl, _ = model.forward(cfg, params,
                              tokens=torch.from_numpy(toks[:, :9]))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    jc = jax_model.init_caches(jcfg, 2, 16)
    c = model.init_caches(cfg, 2, 16, device="cpu")
    for lo, hi in ((0, 9), (9, 10), (10, 11))[:2 if quant else 3]:
        jl, jc, js = jax_model.forward(
            jcfg, jparams, tokens=jnp.asarray(toks[:, lo:hi]), caches=jc,
            quant=quant, return_stats=True)
        tl, c, ts = model.forward(cfg, params,
                                  tokens=torch.from_numpy(toks[:, lo:hi]),
                                  caches=c, quant=quant, return_stats=True)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        for k in ("plane_traffic_fraction", "element_traffic_fraction"):
            assert abs(float(ts[k]) - float(js[k])) <= 1e-6, k
        if quant:
            assert 0 < float(ts["plane_traffic_fraction"]) <= 1


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_full_forward(name):
    """``tests/test_models.py::test_decode_matches_full_forward`` on the
    port: at ``capacity_factor=100`` no slot is dropped, so one token at a
    time through the cache gives the full forward's logits."""
    _, cfg, _, params, _, _ = smoke_model(name)
    cfg = cfg.replace(capacity_factor=100.0)
    b, s = 2, 8
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32))
    full, _ = model.forward(cfg, params, tokens=tokens)
    caches = model.init_caches(cfg, b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, caches = model.forward(cfg, params, tokens=tokens[:, t:t + 1],
                                   caches=caches)
        outs.append(lg[:, 0])
    err = float((full - torch.stack(outs, 1)).abs().max())
    assert err < 1e-4 * max(float(full.abs().max()), 1.0), err
