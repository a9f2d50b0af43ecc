"""Multi-step training on the port (``train/trainer.py``) held against the
reference's ``train_loop``, and the training CLI (``launch/train.py``)
held against itself across a resume in ``test_torch_train_cli.py``.

Three smollm smoke steps at f32 (the reference's weights, the synthetic
batches of ``global_batch`` 4 x 32 tokens, AdamW lr 1e-3, warmup 1) with
``micro_batches`` 1 and 2: each step's loss and ``grad_norm`` within 1e-6
relative (measured 2.1e-7) and ``lr`` within 1e-6; the final params of
every leaf within ``0.05 * lr`` of the reference's (AdamW normalises each
element's step, so an element whose gradient is near zero in both
packages may step by a different fraction of ``lr``: measured 2.4e-5 at lr
1e-3), and all but 1e-3 of each leaf's elements within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import model as jax_model
from repro.optim import adamw as jax_adamw
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import train_loop as jax_train_loop
from repro_torch.configs import get_smoke
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import init_params
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, make_train_step, train_loop
from repro_torch.tree import flatten_with_path, leaves

LR = 1e-3


@pytest.mark.parametrize("micro", [1, 2])
def test_three_steps_match_reference(micro):
    jcfg = jax_get_smoke("smollm_135m").replace(dtype=jnp.float32)
    cfg = get_smoke("smollm_135m").replace(dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_model.init_params(key, jcfg))(jax.random.PRNGKey(0)))
    kw = dict(global_batch=4, seq_len=32, vocab_size=cfg.vocab_size)
    jdata, data = JaxSyntheticLM(JaxDataConfig(**kw)), SyntheticLM(
        DataConfig(**kw))
    okw = dict(lr=LR, warmup_steps=1, total_steps=10)

    want = []
    jparams = jax.tree.map(jnp.asarray, tree)
    jp, _, _ = jax_train_loop(
        jcfg, JaxTrainConfig(optimizer=jax_adamw.AdamWConfig(**okw),
                             micro_batches=micro),
        jparams, jax_adamw.init(jparams),
        (jax.tree.map(jnp.asarray, jdata.batch(s)) for s in range(3)),
        hook=lambda s, m: want.append(m))
    got = []
    params = params_from_numpy(cfg, tree, device="cpu")
    tp, to, _ = train_loop(
        cfg, TrainConfig(optimizer=adamw.AdamWConfig(**okw),
                         micro_batches=micro),
        params, adamw.init(params),
        ({k: torch.from_numpy(v) for k, v in data.batch(s).items()}
         for s in range(3)),
        hook=lambda s, m: got.append((s, m)))
    assert [s for s, _ in got] == [0, 1, 2] and int(to["step"]) == 3
    for (_, g), w in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(g[k]) - float(w[k])) <= 1e-6 * abs(float(w[k]))
        assert g["step_time_s"] > 0 and g["straggler"] in (False, True)
    flat = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    for key, t in flatten_with_path(tp):
        diff = np.abs(t.numpy() - flat[key])
        assert diff.max() <= 0.05 * LR, (key, diff.max())
        assert (diff > 1e-6).mean() <= 1e-3, key


def test_quant_flag_on_a_float_tree_is_the_float_step():
    """``TrainConfig(quant=True)`` over a tree without ``*_q`` leaves
    takes the float projections, as the reference's does."""
    cfg = get_smoke("smollm_135m").replace(dtype=torch.float32)
    params = init_params(cfg, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
        global_batch=2, seq_len=16, vocab_size=cfg.vocab_size)).batch(
        0).items()}
    outs = [make_train_step(cfg, TrainConfig(quant=q))(
        params, adamw.init(params), batch) for q in (False, True)]
    assert torch.equal(outs[0][2]["loss"], outs[1][2]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(outs[0][0]),
                                                 leaves(outs[1][0])))


def test_train_loop_restores_the_determinism_setting():
    cfg = get_smoke("smollm_135m").replace(dtype=torch.float32)
    params = init_params(cfg, generator=torch.Generator().manual_seed(2),
                         device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
        global_batch=2, seq_len=8, vocab_size=cfg.vocab_size)).batch(
        0).items()}
    before = torch.are_deterministic_algorithms_enabled()
    seen = []
    train_loop(cfg, TrainConfig(), params, adamw.init(params), [batch],
               hook=lambda s, m: seen.append(
                   torch.are_deterministic_algorithms_enabled()))
    assert seen == [True]
    assert torch.are_deterministic_algorithms_enabled() == before
