"""One-shot serving on the model axis held against the single device, on
the CPU at f32: the smoke config of smollm here (attention replicated,
MLP and vocab sharded), of qwen3 (heads sharded at M = 2, replicated at
4), deepseek-moe (heads, shared MLP and vocab sharded, the 8 routed
experts expert-parallel) and mamba2 (the 4 SSD heads sharded) in
``test_torch_tp_serve_{qwen3, moe, ssm}.py``, as M = 2 and M = 4 ranks of
a local group (``models.sharding.LocalGroup``), float and quantized with
packed planes and stats.

Bars:

* greedy tokens equal to the reference's single-device run (and every
  rank's equal);
* prefill logits within ``rtol = atol = 1e-5`` of the port's
  single-device logits (a float partial sum crosses ranks in the float
  row-parallel projections and the mamba norm);
* the element-granular plane traffic of every step equal to the single
  device's (each rank counts its columns, or its rows of K); the
  tile-granular fraction is not compared: no rank's K slice here is a
  multiple of K2's 128-row tile.

``test_torch_tp_int32.py`` holds each quantized projection's int32
output and the split-KV merges across ranks bit-equal.

Weights are the reference's ``init_params(PRNGKey(0))`` through
``models.convert``; the port's single-device runs were held against the
reference by earlier test files, so the reference runs once per config
and mode (module fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_params as jax_init_params
from repro.models.quantize import quantize_model_params as jax_quantize
from repro.serving import engine as jax_engine
from repro_torch.configs import get_smoke
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding as sh
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import forward
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import engine

ARCHS = {"smollm-135m": "smollm_135m", "qwen3-32b": "qwen3_32b",
         "deepseek-moe-16b": "deepseek_moe_16b", "mamba2-780m": "mamba2_780m"}
MAX_NEW = 6


def _setup(arch):
    jcfg = jax_get_smoke(ARCHS[arch]).replace(dtype=jnp.float32)
    cfg = get_smoke(arch).replace(dtype=torch.float32)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jprompt = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                 jcfg.vocab_size)
    out = {"cfg": cfg, "prompt": torch.from_numpy(np.array(jprompt))}
    for quant in (False, True):
        jp = jax_quantize(jcfg, jparams, pack=True) if quant else jparams
        p = quantize_model_params(cfg, params, pack=True) if quant \
            else params
        jt = jax_engine.greedy_generate(jcfg, jp, jprompt, MAX_NEW,
                                        quant="xla" if quant else False)
        out[quant] = (p, np.asarray(jt))
    return out


_CACHE = {}


@pytest.fixture(scope="module")
def setups():
    def get(arch):
        if arch not in _CACHE:
            _CACHE[arch] = _setup(arch)
        return _CACHE[arch]
    yield get
    _CACHE.clear()


def _ranks(cfg, params, m, fn):
    """``fn(local_params)`` on each of ``m`` local ranks."""
    mesh = Mesh((1, m), sh.LocalGroup(m, timeout=120))
    specs = shardings.params_shardings(mesh, params, fsdp=False,
                                       kv_heads=cfg.n_kv_heads)

    def rank(r):
        return fn(shardings.shard_params(params, specs, mesh, r), mesh)
    return mesh.run(rank)


def check_one_shot(setups, arch, quant, m):
    """``m`` ranks' greedy tokens, prefill logits and traffic against the
    reference's tokens and the port's single device."""
    s = setups(arch)
    cfg, prompt = s["cfg"], s["prompt"]
    params, jtokens = s[quant]
    want_logits, _ = forward(cfg, params, tokens=prompt, quant=quant)
    _, want_stats = engine.greedy_generate(
        cfg, params, prompt, MAX_NEW, quant=quant, with_stats=True,
        device="cpu") if quant else (None, None)

    def fn(local, mesh):
        toks = engine.greedy_generate(cfg, local, prompt, MAX_NEW,
                                      quant=quant, with_stats=quant,
                                      device="cpu", mesh=mesh)
        logits, _ = forward(cfg, local, tokens=prompt, quant=quant)
        return toks, logits

    outs = _ranks(cfg, params, m, fn)
    for toks, logits in outs:
        got = toks[0] if quant else toks
        np.testing.assert_array_equal(got.numpy(), jtokens)
        torch.testing.assert_close(logits, want_logits, rtol=1e-5,
                                   atol=1e-5)
        if quant:
            np.testing.assert_allclose(
                toks[1]["element_traffic_fraction"].numpy(),
                want_stats["element_traffic_fraction"].numpy(), rtol=0,
                atol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "quant"])
def test_one_shot_tokens_equal_reference(setups, quant, m):
    check_one_shot(setups, "smollm-135m", quant, m)
