"""The flash-attention backward of the port (``models/attention.py``
``FlashAttention``, the reference's custom VJP ``_make_flash``) held
against the JAX package at f32, and the forward's ``positions=`` argument.

Inputs are made from a seed with numpy.  Shapes: batch 2, 40 queries and
40 keys, 6 query heads over 2 KV heads (GQA, 3 a group), head dim 16,
``kv_chunk`` 12 (four chunks, the last padded by 8 keys) and 64 (one
chunk); causal and not, with and without ``kv_valid_len``.  The output and
dq, dk, dv agree with ``jax.vjp`` of the reference, and with torch
autograd through the plain chunked forward (``flash_forward``), within
``REL`` = 2e-6 of each tensor's largest magnitude (the three sum the
chunk products in other orders; measured at most 6.8e-7 of it, against
both).  The Function saves no tensor of a chunk's score shape (..., Sq,
C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro_torch.configs import get_smoke
from repro_torch.models import attention, model
from repro_torch.models.convert import params_from_numpy

B, SQ, H, G, D = 2, 40, 6, 2, 16
REL = 2e-6


def _close(got, want, name):
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), (name, err)


def _inputs(seed, valid):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, SQ, H, D)).astype(np.float32)
    k = rng.standard_normal((B, SQ, G, D)).astype(np.float32)
    v = rng.standard_normal((B, SQ, G, D)).astype(np.float32)
    do = rng.standard_normal((B, SQ, H, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SQ, dtype=np.int32), (B, SQ)).copy()
    lens = np.array([SQ, 23], np.int32) if valid else None
    return q, k, v, do, pos, lens


def _torch_grads(fn, q, k, v, do):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("chunk", [12, 64])
def test_flash_backward_matches_reference_vjp(chunk, valid, causal):
    q, k, v, do, pos, lens = _inputs(chunk + 2 * valid + causal, valid)
    jl = None if lens is None else jnp.asarray(lens)

    def jfn(q_, k_, v_):
        return jax_attention.flash_attention(
            q_, k_, v_, jnp.asarray(pos), jnp.asarray(pos), causal=causal,
            kv_chunk=chunk, kv_valid_len=jl)

    jout, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(jout)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tp = torch.from_numpy(pos)
    tl = None if lens is None else torch.from_numpy(lens)
    got = _torch_grads(lambda q_, k_, v_: attention.flash_attention(
        q_, k_, v_, tp, tp, causal=causal, kv_chunk=chunk,
        kv_valid_len=tl), q, k, v, do)
    plain = _torch_grads(lambda q_, k_, v_: attention.flash_forward(
        q_, k_, v_, tp, tp, causal, min(chunk, SQ), tl)[0], q, k, v, do)
    for name, g, w, pl in zip(("out", "dq", "dk", "dv"), got, want, plain):
        _close(g, w, name)
        _close(g, pl, name + " (plain autograd)")
    if valid:                  # keys past a row's valid length get nothing
        assert not got[2][1, 23:].any() and not got[3][1, 23:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_saves_no_score_shaped_tensor(dtype):
    q, k, v, do, pos, _ = _inputs(0, False)
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    tp = torch.from_numpy(pos)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = attention.flash_attention(*ts, tp, tp, kv_chunk=12)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do).to(dtype))
    assert shapes and not [s for s in shapes if s[-2:] == (SQ, 12)], shapes
    g, r = G, H // G
    assert (B, g, r, SQ, D) in shapes and (B, g, r, SQ) in shapes, shapes
    assert all(gr.dtype == dtype and bool(torch.isfinite(gr).all())
               for gr in grads)


def test_no_function_without_autograd():
    """Serving calls (no grad) take the plain forward: nothing is saved."""
    q, k, v, _, pos, _ = _inputs(1, False)
    tp = torch.from_numpy(pos)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    out = attention.flash_attention(*ts, tp, tp, kv_chunk=12)
    assert out.grad_fn is None
    want = attention.flash_forward(*ts, tp, tp, True, 12)[0]
    assert torch.equal(out, want)


def test_forward_positions_override():
    """``forward(positions=)`` with explicit, non-contiguous positions
    gives the reference's logits (f32 smollm smoke, rtol = atol = 1e-5),
    and differs from the derived positions."""
    jcfg = jax_get_smoke("smollm_135m").replace(dtype=jnp.float32)
    cfg = get_smoke("smollm_135m").replace(dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_model.init_params(key, jcfg))(jax.random.PRNGKey(3)))
    params = params_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    pos = np.stack([np.array([0, 2, 3, 7, 8, 20, 21, 22, 40]),
                    np.array([5, 6, 9, 10, 11, 30, 31, 60, 61])]
                   ).astype(np.int32)
    jl, _ = jax_model.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                              tokens=jnp.asarray(toks),
                              positions=jnp.asarray(pos))
    tl, _ = model.forward(cfg, params, tokens=torch.from_numpy(toks),
                          positions=torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    derived, _ = model.forward(cfg, params, tokens=torch.from_numpy(toks))
    assert not torch.allclose(tl, derived, rtol=1e-3, atol=1e-3)
