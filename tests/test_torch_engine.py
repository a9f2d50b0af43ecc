"""The port's one-shot serving engine held against the JAX package's on
the smoke config at f32 (the prompts of ``tests/test_serving_fused.py``):
greedy tokens are equal, float and QeiHaN-quantized, packed and unpacked,
with and without ``eos_id``; per-step plane-traffic fractions agree within
1e-6; ``reference_generate`` equals ``greedy_generate``.  The JAX side runs
``quant="xla"``, which ``test_quant_pallas_matches_xla_exactly`` shows is
bit-identical to its Pallas path.  Entry points called without a device
on a host with no CUDA raise instead of running on the CPU."""

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
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import engine


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_smoke("smollm_135m").replace(dtype=jnp.float32)
    cfg = get_smoke("smollm-135m").replace(dtype=torch.float32)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jprompt = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                 jcfg.vocab_size)
    prompt = torch.from_numpy(np.array(jprompt))
    return jcfg, cfg, jparams, params, jprompt, prompt


@pytest.fixture(scope="module")
def qsetup(setup):
    jcfg, cfg, jparams, params, jprompt, prompt = setup
    return {pack: (jax_quantize(jcfg, jparams, pack=pack),
                   quantize_model_params(cfg, params, pack=pack))
            for pack in (False, True)}


def _generate_both(setup, qsetup, quant, pack=False, eos=None, max_new=6,
                   with_stats=False):
    jcfg, cfg, jparams, params, jprompt, prompt = setup
    if quant:
        jparams, params = qsetup[pack]
    jout = jax_engine.greedy_generate(
        jcfg, jparams, jprompt, max_new, quant="xla" if quant else False,
        eos_id=eos, with_stats=with_stats)
    out = engine.greedy_generate(cfg, params, prompt, max_new, quant=quant,
                                 eos_id=eos, with_stats=with_stats,
                                 device="cpu")
    return jout, out


@pytest.mark.parametrize("quant,pack", [(False, False), (True, False),
                                        (True, True)])
def test_greedy_tokens_equal_reference(setup, qsetup, quant, pack):
    jt, t = _generate_both(setup, qsetup, quant, pack)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert t.shape == (2, 6) and t.dtype == torch.int32


@pytest.mark.parametrize("quant", [False, True])
def test_eos_early_stop_tokens_equal_reference(setup, qsetup, quant):
    jt, _ = _generate_both(setup, qsetup, quant)
    eos = int(np.asarray(jt)[0, 2])
    (jt2, js), (t2, st) = _generate_both(setup, qsetup, quant, eos=eos,
                                         with_stats=True)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(jt2))
    for key in ("plane_traffic_fraction", "element_traffic_fraction"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(js[key]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("pack", [False, True])
def test_per_step_traffic_fractions_match_reference(setup, qsetup, pack):
    (jt, js), (t, st) = _generate_both(setup, qsetup, True, pack,
                                       with_stats=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    for key in ("plane_traffic_fraction", "element_traffic_fraction"):
        got, want = st[key].numpy(), np.asarray(js[key])
        assert got.shape == (6,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert (got[:-1] > 0).all() and got[-1] == 0.0   # dead last step


@pytest.mark.parametrize("quant", [False, True])
def test_reference_generate_equals_greedy(setup, qsetup, quant):
    _, cfg, _, params, _, prompt = setup
    if quant:
        params = qsetup[False][1]
    a = engine.reference_generate(cfg, params, prompt, 5, quant=quant,
                                  device="cpu")
    b = engine.greedy_generate(cfg, params, prompt, 5, quant=quant,
                               device="cpu")
    assert torch.equal(a, b)


def test_temperature_sampling_follows_its_generator(setup):
    _, cfg, _, params, _, prompt = setup

    def run(seed, **kw):
        return engine.greedy_generate(
            cfg, params, prompt, 5, temperature=0.8, device="cpu",
            generator=torch.Generator().manual_seed(seed), **kw)

    a, b = run(7), run(7)
    assert torch.equal(a, b)
    ref = engine.reference_generate(
        cfg, params, prompt, 5, temperature=0.8, device="cpu",
        generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, ref)
    eos = int(a[1, 1])
    c = run(7, eos_id=eos)
    for r in range(a.shape[0]):
        hits = np.nonzero(a[r].numpy() == eos)[0]
        j = int(hits[0]) if hits.size else a.shape[1] - 1
        assert torch.equal(c[r, :j + 1], a[r, :j + 1])
        assert (c[r, j:] == eos).all() or not hits.size


def test_serve_cli_runs_on_cpu(capsys):
    serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
                "--quant", "--pack"])
    out = capsys.readouterr().out
    assert "[serve] smollm-135m-smoke on cpu: prefill 2x8" in out
    assert "tok/s" in out and "plane_traffic_fraction" in out
    assert "sample tokens:" in out


def test_entry_points_refuse_the_cpu_unless_asked(setup, monkeypatch):
    _, cfg, jparams, params, _, prompt = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = jax.tree.map(np.asarray, jparams)
    calls = [
        lambda: model.init_params(cfg),
        lambda: model.init_caches(cfg, 1, 4),
        lambda: params_from_numpy(cfg, tree),
        lambda: engine.greedy_generate(cfg, params, prompt, 2),
        lambda: engine.reference_generate(cfg, params, prompt, 2),
        lambda: serve.main(["--arch", "smollm-135m", "--smoke"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
