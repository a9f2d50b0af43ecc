"""``next_token_loss`` and its gradients on the port, held against
``jax.value_and_grad`` of the reference's at f32, config by config.

Each smoke config's weights come from the reference's ``init_params``
(key 0, with :func:`test_torch_dense_variants.randomized` biases, norms
and ``img_proj``) and go to both packages; the batch (tokens or the audio
stub's embeddings, the vision stub's patch embeddings, labels and a 0/1
mask) is drawn with numpy from a seed.  The loss agrees within 1e-6
relative; every gradient leaf's largest difference stays under ``REL`` =
2e-5 of that leaf's largest magnitude (XLA and ATen sum in other orders;
measured at most 8.4e-6, on jamba's ``dt_bias``).  The reference's step is
jitted (as its trainer's is).  This file holds the dense configs and the
two stubs; ``test_torch_train_grads_moe_ssm.py`` the MoE and SSM ones.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import model as jax_model
from repro_torch.configs import get_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.trainer import make_loss_fn, value_and_grad
from repro_torch.tree import flatten_with_path
from test_torch_dense_variants import randomized

ARCHS = ["qwen3_32b", "qwen25_14b", "smollm_135m", "phi4_mini_3p8b",
         "musicgen_medium", "internvl2_26b"]
REL = 2e-5


@functools.lru_cache(maxsize=None)
def smoke_tree(name):
    """(jcfg, cfg, numpy tree) of a smoke config at f32."""
    jcfg = jax_get_smoke(name).replace(dtype=jnp.float32)
    cfg = get_smoke(name).replace(dtype=torch.float32)
    tree = randomized(jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_model.init_params(key, jcfg))(jax.random.PRNGKey(0))))
    return jcfg, cfg, tree


def make_batch(cfg, b=2, s=16, seed=0, mask=True):
    """A numpy training batch for ``cfg`` (``tests/test_models.py``'s
    layout): ``s`` rows in all, the vision stub's image rows included."""
    rng = np.random.default_rng(seed)
    out = {}
    st = s - cfg.n_image_tokens if cfg.frontend == "vision_stub" else s
    if cfg.frontend == "audio_stub":
        out["embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (b, st)).astype(np.int32)
    if cfg.frontend == "vision_stub":
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, st)).astype(np.int32)
    if mask:
        out["mask"] = (rng.random((b, st)) < 0.8).astype(np.float32)
    return out


def reference_value_and_grad(jcfg, tree, batch):
    """(loss, {keystr: grad}) of the reference, jitted."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model.next_token_loss(jcfg, p, b)))
    loss, grads = fn(jax.tree.map(jnp.asarray, tree),
                     jax.tree.map(jnp.asarray, batch))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return float(loss), {jax.tree_util.keystr(p): np.asarray(g)
                         for p, g in flat}


def check_config(name):
    jcfg, cfg, tree = smoke_tree(name)
    batch = make_batch(cfg, seed=len(name))
    want_loss, want = reference_value_and_grad(jcfg, tree, batch)
    params = params_from_numpy(cfg, tree, device="cpu")
    loss, grads = value_and_grad(
        make_loss_fn(cfg), params,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - want_loss) <= 1e-6 * abs(want_loss)
    got = flatten_with_path(grads)
    assert sorted(k for k, _ in got) == sorted(want)
    for key, g in got:
        w = want[key]
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        assert np.isfinite(g).all(), key
        err = float(np.abs(g - w).max())
        assert err <= REL * float(np.abs(w).max()), (key, err)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name):
    check_config(name)
