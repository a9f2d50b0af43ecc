"""The port's paper nets (``repro_torch.models.paper_nets``) held against
the JAX package's (``repro.models.paper_nets``) on the same weights.

The reference draws its weights inside each forward from a JAX key and
exposes no parameter tree, so :func:`reference_params` replays its draws
(the same key splits in the same order, the same expressions) into numpy
arrays under the port's keys; ``paper_params_from_numpy`` carries them
into the port.  A wrong draw order cannot pass the value checks below.

The recorded activations have the reference's names, order and shapes,
and values within 1e-4 x the tensor's largest magnitude; the port's LOG2
quantizer on the reference's own activations gives the reference's codes
bit for bit.  At full size, every net's shapes equal ``jax.eval_shape``'s
of the reference, the port running on the ``meta`` device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import log2_quantize as jax_log2_quantize
from repro.models import paper_nets as jax_pn
from repro_torch.core.logquant import log2_quantize
from repro_torch.models import paper_nets
from repro_torch.models.convert import paper_params_from_numpy

ENCODER_BLOCK = ("q", "k", "v", "o", "ff1", "ff2")


def _encoder_arrays(key, n_layers, d, ff, seq, prefix=""):
    """``_encoder_activations``'s draws (paper_nets.py:108-131)."""
    ks = iter(jax.random.split(key, 6 * n_layers + 2))
    out = {prefix + "x": jax.random.normal(next(ks), (seq, d)) * 1.0}
    for l in range(n_layers):
        for w, (k, n) in zip(ENCODER_BLOCK,
                             [(d, d)] * 4 + [(d, ff), (ff, d)]):
            out[f"{prefix}l{l}.{w}"] = jax_pn._dense(next(ks), k, n)
    return {k: np.asarray(v) for k, v in out.items()}


def reference_params(name, key, **sizes):
    """The reference's weights and input for net ``name`` drawn from
    ``key``, as numpy arrays under ``init_paper_params``' keys."""
    if name == "alexnet":                      # paper_nets.py:41-67
        ks = iter(jax.random.split(key, 16))
        out = {"x": jax.random.normal(next(ks), (1, 227, 227, 3),
                                      jnp.float32)}
        ic = 3
        for cname, oc, kh in [("conv1", 96, 11), ("conv2", 256, 5),
                              ("conv3", 384, 3), ("conv4", 384, 3),
                              ("conv5", 256, 3)]:
            out[cname] = (jax.random.normal(next(ks), (kh, kh, ic, oc))
                          * jnp.sqrt(2.0 / (kh * kh * ic)))
            ic = oc
        k = 9216
        for fname, n in [("fc6", 4096), ("fc7", 4096), ("fc8", 1000)]:
            out[fname] = jax_pn._dense(next(ks), k, n, jnp.sqrt(2.0 / k))
            k = n
    elif name == "ptblm":                      # paper_nets.py:75-78
        seq, hidden = sizes.get("seq", 35), sizes.get("hidden", 1500)
        ks = iter(jax.random.split(key, 8))
        out = {"emb": jax.random.normal(next(ks), (seq, hidden)) * 0.1}
        for l in range(2):
            out[f"w{l}"] = jax_pn._dense(next(ks), 2 * hidden, 4 * hidden)
    elif name == "transformer":                # paper_nets.py:136
        k1, k2 = jax.random.split(key)
        seq = sizes.get("seq", 128)
        out = {**_encoder_arrays(k1, 6, 512, 2048, seq),
               **_encoder_arrays(k2, 6, 512, 2048, seq, prefix="dec_")}
    else:
        n_layers, d, ff = {"bert-base": (12, 768, 3072),
                           "bert-large": (24, 1024, 4096)}[name]
        out = _encoder_arrays(key, n_layers, d, ff, sizes.get("seq", 128))
    return {k: np.asarray(v) for k, v in out.items()}


def assert_acts_match(acts, ref_acts):
    """Names, order, shapes; values within 1e-4 x max|ref|; the port's
    codes on the reference's activations equal the reference's."""
    assert [n for n, _ in acts] == [n for n, _ in ref_acts]
    for (name, a), (_, r) in zip(acts, ref_acts):
        r = np.asarray(r)
        assert tuple(a.shape) == r.shape, name
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)
        q = log2_quantize(torch.from_numpy(r.copy()))
        qj = jax_log2_quantize(jnp.asarray(r))
        np.testing.assert_array_equal(q.exp.numpy(), np.asarray(qj.exp),
                                      err_msg=name)
        np.testing.assert_array_equal(q.sign.numpy(), np.asarray(qj.sign),
                                      err_msg=name)


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_encoder_narrow_matches_reference(act):
    key = jax.random.PRNGKey(3)
    ref = jax_pn._encoder_activations(
        key, 2, 128, 256, 8,
        act_fn={"relu": jax.nn.relu, "gelu": jax.nn.gelu}[act])
    params = paper_params_from_numpy(
        "bert-base", _encoder_arrays(key, 2, 128, 256, 8), "cpu")
    acts = paper_nets._encoder_activations(params, act)
    assert len(acts) == 8
    assert_acts_match(acts, ref)


def test_ptblm_narrow_matches_reference():
    key = jax.random.PRNGKey(4)
    ref = jax_pn.ptblm_activations(key, seq=4, hidden=32)
    params = paper_params_from_numpy(
        "ptblm", reference_params("ptblm", key, seq=4, hidden=32), "cpu")
    acts = paper_nets.ptblm_activations(params)
    assert [tuple(a.shape) for _, a in acts] == [(4, 64), (4, 64), (4, 32)]
    assert_acts_match(acts, ref)


@pytest.fixture(scope="module")
def alexnet_pair():
    key = jax.random.PRNGKey(0)
    ref = [(n, np.asarray(a)) for n, a in jax_pn.alexnet_activations(key)]
    params = paper_params_from_numpy(
        "alexnet", reference_params("alexnet", key), "cpu")
    return paper_nets.alexnet_activations(params), ref


def test_alexnet_matches_reference(alexnet_pair):
    acts, ref = alexnet_pair
    assert_acts_match(acts, ref)
    # NHWC records, flattened in NHWC order before fc6
    assert tuple(acts[4][1].shape) == (1, 13, 13, 384)
    assert tuple(acts[5][1].shape) == (1, 9216)


def _reference_shapes(name):
    names = []

    def fn(key):
        acts = jax_pn.PAPER_ACTIVATIONS[name](key)
        names[:] = [n for n, _ in acts]
        return [a for _, a in acts]

    shapes = jax.eval_shape(fn, jax.random.PRNGKey(0))
    return [(n, tuple(s.shape)) for n, s in zip(names, shapes)]


@pytest.mark.parametrize("name", sorted(jax_pn.PAPER_ACTIVATIONS))
def test_full_size_shapes_match_reference(name):
    """The published sizes: the reference abstractly, the port on the
    ``meta`` device (no memory, no arithmetic)."""
    params = paper_nets.init_paper_params(name, device="meta")
    acts = paper_nets.PAPER_ACTIVATIONS[name](params)
    got = [(n, tuple(a.shape)) for n, a in acts]
    assert got == _reference_shapes(name)
    assert all(a.device.type == "meta" and a.dtype == torch.float32
               for _, a in acts)
    # K1's launches on the card: one per recorded tensor
    assert len(acts) == {"alexnet": 8, "ptblm": 3, "transformer": 48,
                         "bert-base": 48, "bert-large": 96}[name]


def test_init_params_keys_match_reference_draws():
    """``init_paper_params`` draws the keys, shapes and scales the replay
    gives (narrow sizes; the values are the port's own draw), and the
    transformer's encoder and ``dec_`` halves."""
    g = torch.Generator().manual_seed(0)
    cases = [(paper_nets.init_paper_params("ptblm", g, "cpu", seq=3,
                                           hidden=16),
              reference_params("ptblm", jax.random.PRNGKey(1), seq=3,
                               hidden=16)),
             (paper_nets._encoder_params(g, "cpu", 2, 128, 256, 4),
              _encoder_arrays(jax.random.PRNGKey(1), 2, 128, 256, 4))]
    for mine, ref in cases:
        assert list(mine) == list(ref)
        for k in ref:
            assert tuple(mine[k].shape) == ref[k].shape, k
            assert mine[k].dtype == torch.float32
            std, want = float(mine[k].std()), float(ref[k].std())
            assert 0.7 * want < std < 1.3 * want, (k, std, want)
    meta = paper_nets.init_paper_params("transformer", device="meta")
    half = list(paper_nets._encoder_params(None, "meta", 6, 512, 2048, 128))
    assert list(meta) == half + ["dec_" + k for k in half]
    with pytest.raises(KeyError):
        paper_nets.init_paper_params("vgg", device="cpu")
    with pytest.raises(TypeError):
        paper_nets.init_paper_params("bert-base", device="cpu", hidden=3)
