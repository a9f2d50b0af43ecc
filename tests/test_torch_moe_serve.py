"""The port's ``ServeScheduler`` serving the MoE smoke configs, held
against the JAX package's scheduler at f32 tick by tick: the same
``ServeConfig``, the same weights (``models.convert``) and prompts, equal
in every request's tokens, finish reasons and ticks, the per-slot lengths
after each tick and, paged, the page tables, refcounts, free list and
``prefix_cache_stats()`` after each tick (``tests/test_torch_scheduler.py``'s
comparison).

Expert capacity follows each call's row count, so every row of a tick
(inactive slots too), a chunk slab and a bucketed prefill competes for an
expert as in the reference: tokens agree only if the port routes the same
rows in the same order.  At deepseek-moe smoke's 8 experts top-3, a tick
of 3 slots admits 2 slots per expert and drops the rest.

Modes: deepseek-moe smoke paged with the prefix cache and the
paged-attention kernel's plain version (splits 2), float and quantized
with stats, and over the log2-quantized pool; jamba smoke paged with the
prefix cache over the quantized pool, ``chunked="always"`` (the
reference's ``tests/test_kv_quant.py`` hybrid case: SSM snapshots and the
quantized tail ring restored together); and jamba smoke at ``pattern=
("mamba_moe", "attn")``, whose only recurrent kind is ``mamba_moe``: the
scheduler must still take SSM snapshots.  Then the CLI on
``--arch deepseek-moe-16b --smoke``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_params as jax_init_params
from repro.models.quantize import quantize_model_params as jax_quantize
from repro.serving.config import ServeConfig as JaxServeConfig
from repro.serving.scheduler import ServeScheduler as JaxScheduler
from repro_torch.configs import get_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import ServeConfig, ServeScheduler
from test_torch_moe import count_drops
from test_torch_scheduler import PAGED, _compare, _drive
from test_torch_scheduler import _prompts as _shared_prompts


def _model(name, quant=False, **kw):
    jcfg = jax_get_smoke(name).replace(dtype=jnp.float32, **kw)
    cfg = get_smoke(name).replace(dtype=torch.float32, **kw)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    if quant:
        jparams = jax_quantize(jcfg, jparams)
        params = quantize_model_params(cfg, params)
    return jcfg, jparams, cfg, params


def _prefix_prompts(seed, lengths, prefix_len=16, vocab=256):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=prefix_len).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, size=n)
                            .astype(np.int32)]) for n in lengths]


def _run_both(model, kw, prompts, max_new):
    jcfg, jparams, cfg, params = model
    ref = _drive(JaxScheduler(jcfg, jparams, JaxServeConfig(**kw)),
                 prompts, max_new)
    sched = ServeScheduler(cfg, params, ServeConfig(**kw), device="cpu")
    return ref, _drive(sched, prompts, max_new), sched


K3 = dict(PAGED, attn_kernel="pallas", attn_splits=2)
DEEPSEEK_MODES = {
    "paged_k3_s2": (K3, False),
    "quant_paged_k3_stats": (dict(K3, quant="xla", with_stats=True), True),
    "kv_quant_k4": (dict(K3, kv_quant=True, page_len=8), False),
}


@pytest.mark.parametrize("mode", list(DEEPSEEK_MODES))
def test_deepseek_scheduler_matches_reference(mode, monkeypatch):
    kw, quant = DEEPSEEK_MODES[mode]
    dropped = count_drops(monkeypatch)
    ref, ours, sched = _run_both(_model("deepseek_moe_16b", quant), kw,
                                 _shared_prompts(), 6)
    _compare(ref, ours)
    assert sum(dropped) > 0
    results = ours[2]
    assert len(results) == 8
    assert all(r.finish_reason == "length" and len(r.tokens) == 6
               for r in results)
    assert sched.prefix_cache_stats()["lookup_hits"] >= 2
    if quant:
        assert all(0 < r.plane_traffic_fraction <= 1 for r in results)


def test_jamba_kv_quant_snapshots_match_reference():
    """The reference's hybrid snapshot case (tests/test_kv_quant.py):
    one slot, chunked always, quantized pool; two hits restore the SSM
    snapshot and the quantized tail ring."""
    kw = dict(max_slots=1, max_len=64, buckets=(8, 16, 32), tick_steps=3,
              paged=True, page_len=8, prefix_cache=True, chunked="always",
              chunk_len=8, kv_quant=True)
    ref, ours, sched = _run_both(_model("jamba_v01_52b"), kw,
                                 _prefix_prompts(5, (5, 4, 6)), 6)
    _compare(ref, ours)
    assert all(len(r.tokens) == 6 for r in ours[2])
    assert sched.prefix_cache_stats()["lookup_hits"] == 2
    assert sched._radix._n_snapshots >= 1


def test_mamba_moe_only_recurrent_kind_takes_snapshots():
    """``pattern=("mamba_moe", "attn")``: the scheduler finds the SSM
    state by the base kind, takes the snapshot at the page-aligned
    boundary and hits through it, as the reference does."""
    kw = dict(max_slots=1, max_len=64, buckets=(8, 16, 32), tick_steps=3,
              paged=True, page_len=8, prefix_cache=True, chunked="always",
              chunk_len=8)
    model = _model("jamba_v01_52b", pattern=("mamba_moe", "attn"))
    ref, ours, sched = _run_both(model, kw, _prefix_prompts(8, (0, 5, 3)), 5)
    _compare(ref, ours)
    assert sched._has_ssm
    st = sched.prefix_cache_stats()
    assert st["lookup_hits"] == 2 and st["cached_tokens"] == 32, st
    assert sched._radix._n_snapshots >= 1


def test_cli_serves_deepseek_moe_on_the_host(capsys):
    """``launch.serve --arch deepseek-moe-16b --smoke`` one-shot
    (quantized on packed planes) and continuous over the quantized pool:
    ``--kv-quant`` is accepted for an ``attn_moe`` model and still refused
    for the attention-free mamba2-780m."""
    from repro_torch.launch import serve

    base = ["--smoke", "--device", "cpu", "--new-tokens", "4",
            "--prompt-len", "8"]
    ds = ["--arch", "deepseek-moe-16b"] + base
    serve.main(ds + ["--batch", "2", "--quant", "--pack"])
    results = serve.main(ds + ["--continuous", "--kv-quant", "4",
                               "--prefix-cache", "--attn-kernel",
                               "--page-len", "4", "--requests", "5",
                               "--max-slots", "2"])
    out = capsys.readouterr().out
    assert "plane_traffic_fraction" in out and "prefix cache:" in out
    assert len(results) == 5 and all(len(r.tokens) == 4 for r in results)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "mamba2-780m"] + base
                   + ["--continuous", "--kv-quant", "4"])
    assert "no attention layer" in capsys.readouterr().err
