"""The frontend stubs of the port, held against the JAX package at f32 on
the smoke configs: the vision stub of internvl2-26b (``img_proj`` of
patch embeddings prepended to the token embeddings) and the audio stub of
musicgen-medium (frame embeddings in place of token ids).  The weights
are the reference's, with ``img_proj`` redrawn
(``test_torch_dense_variants.randomized``).

The vision stub's one-shot serving runs ``make_prefill_step`` and
``make_decode_loop`` over a cache of ``n_image_tokens + prompt + new``
rows on both sides: the reference's CLI sizes its cache without the
image rows (``src/repro/launch/serve.py:311``), which overflows, so the
reference is driven here through its engine directly.  The audio stub is
decoded frame by frame from seeded embeddings, the loop of the reference's
``examples/serve_decode.py``.  The scheduler and the port's CLI refuse
what the reference's refuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jax_model
from repro.serving import engine as jax_engine
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.serving import ServeConfig, ServeScheduler, engine
from test_torch_dense_variants import TOL, both


def _images(cfg, b, seed=7):
    return np.random.default_rng(seed).normal(
        0, 1, (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


def _prompt(cfg, b, s, seed=8):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("quant", [False, True])
def test_vision_prefill_logits_match_reference(quant):
    """A forward with ``image_embeds``, without a cache and as a cached
    prefill: every row's logits, the image rows' too; the cache length
    counts the image rows."""
    jcfg, jparams, cfg, params = both("internvl2_26b", quant)
    b, s = 2, 6
    img, toks = _images(cfg, b), _prompt(cfg, b, s)
    q = "xla" if quant else False
    jl, _ = jax_model.forward(jcfg, jparams, tokens=jnp.asarray(toks),
                              image_embeds=jnp.asarray(img), quant=q)
    tl, _ = model.forward(cfg, params, tokens=torch.from_numpy(toks),
                          image_embeds=torch.from_numpy(img), quant=quant)
    assert tl.shape == (b, cfg.n_image_tokens + s, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    n = cfg.n_image_tokens + s
    jc = jax_model.init_caches(jcfg, b, n + 1, dtype=jcfg.dtype)
    c = model.init_caches(cfg, b, n + 1, dtype=cfg.dtype, device="cpu")
    jl2, jc = jax_model.forward(jcfg, jparams, tokens=jnp.asarray(toks),
                                image_embeds=jnp.asarray(img), caches=jc,
                                quant=q)
    tl2, c = model.forward(cfg, params, tokens=torch.from_numpy(toks),
                           image_embeds=torch.from_numpy(img), caches=c,
                           quant=quant)
    assert c["length"] == n == int(jc["length"])
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)


@pytest.mark.parametrize("quant,pack", [(False, False), (True, False),
                                        (True, True)])
def test_vision_prefill_then_decode_loop_matches_reference(quant, pack):
    """``make_prefill_step`` over ``{"tokens", "image_embeds"}``, then
    ``make_decode_loop``: tokens equal, traffic fractions within 1e-6."""
    jcfg, jparams, cfg, params = both("internvl2_26b", quant, pack)
    b, s, new = 2, 8, 6
    img, toks = _images(cfg, b), _prompt(cfg, b, s)
    n = cfg.n_image_tokens + s + new
    q = "xla" if quant else False
    jlog, jc = jax.jit(jax_engine.make_prefill_step(jcfg, q))(
        jparams, {"tokens": jnp.asarray(toks),
                  "image_embeds": jnp.asarray(img)},
        jax_model.init_caches(jcfg, b, n, dtype=jcfg.dtype))
    jt, js = jax.jit(jax_engine.make_decode_loop(
        jcfg, new, quant=q, with_stats=quant))(jparams, jc, jlog,
                                               jax.random.PRNGKey(0))
    logits, c = engine.make_prefill_step(cfg, quant)(
        params, {"tokens": torch.from_numpy(toks),
                 "image_embeds": torch.from_numpy(img)},
        model.init_caches(cfg, b, n, dtype=cfg.dtype, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TOL)
    t, st = engine.make_decode_loop(cfg, new, quant=quant,
                                    with_stats=quant)(params, c, logits)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    if quant:
        for key in ("plane_traffic_fraction", "element_traffic_fraction"):
            np.testing.assert_allclose(st[key].numpy(), np.asarray(js[key]),
                                       rtol=0, atol=1e-6)


def test_cli_serves_the_vision_stub_on_the_host(capsys):
    base = ["--arch", "internvl2-26b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--new-tokens", "6"]
    serve.main(base)
    serve.main(base + ["--quant", "--pack"])
    out = capsys.readouterr().out
    assert out.count("prefill 2x8 + 8 image rows") == 2
    assert "plane_traffic_fraction" in out
    assert out.count("sample tokens:") == 2


@pytest.mark.parametrize("name", ["internvl2_26b", "musicgen_medium"])
def test_scheduler_refuses_the_stubs(name):
    _, _, cfg, params = both(name)
    with pytest.raises(ValueError, match="token-id models only"):
        ServeScheduler(cfg, params, ServeConfig(max_slots=2, max_len=32,
                                                buckets=(8,)), device="cpu")


@pytest.mark.parametrize("quant", [False, True])
def test_audio_frame_decode_matches_reference(quant):
    """Frame-by-frame decode from seeded frame embeddings through
    ``make_serve_step``: every step's logits and argmax tokens."""
    jcfg, jparams, cfg, params = both("musicgen_medium", quant)
    b, new = 2, 6
    embs = np.random.default_rng(9).normal(
        0, 1, (new, b, 1, cfg.d_model)).astype(np.float32)
    q = "xla" if quant else False
    jstep = jax.jit(jax_engine.make_serve_step(jcfg, q))
    step = engine.make_serve_step(cfg, quant)
    jc = jax_model.init_caches(jcfg, b, new, dtype=jcfg.dtype)
    c = model.init_caches(cfg, b, new, dtype=cfg.dtype, device="cpu")
    jt, t = [], []
    for e in embs:
        jl, jc = jstep(jparams, jc, jnp.asarray(e))
        tl, c = step(params, c, torch.from_numpy(e))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        jt.append(np.asarray(jnp.argmax(jl, -1)))
        t.append(torch.argmax(tl, -1).numpy())
    np.testing.assert_array_equal(np.stack(t, 1), np.stack(jt, 1))
    assert c["length"] == new


def test_cli_refuses_the_audio_stub():
    with pytest.raises(SystemExit, match="audio stub"):
        serve.main(["--arch", "musicgen-medium", "--smoke", "--device",
                    "cpu"])
