"""The port's ``ServeScheduler`` serving Mamba-2 (and a mamba + attention
hybrid) held against the JAX package's scheduler at f32: the same
``ServeConfig``, the same weights (``models.convert``) and prompts, driven
tick by tick, equal in every request's tokens, finish reasons and ticks,
the per-slot lengths after each tick and, paged, the page tables,
refcounts, free list and ``prefix_cache_stats()`` after each tick
(``tests/test_torch_scheduler.py``'s comparison).

Modes: the reference's own mamba cases (bucketed right-padded prefill,
``tests/test_serve_scheduler.py``; the paged pool and the prefix hit
through an SSM snapshot, ``tests/test_serve_paged.py``; chunked "auto"
and "always", ``tests/test_serve_chunked.py``), a snapshot taken at a
page-aligned bucketed admission, one taken after a last chunk that lands
on the page boundary (its row held out of that tick's decode), and
quantized with stats on the paged pool.  The hybrid ``pattern=("mamba",
"attn")`` serves paged with the prefix cache and the paged-attention
kernel's plain version, so that attention pages, copy-on-write refusal
and SSM snapshots share one pool.
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
from test_torch_scheduler import _compare, _drive

HYBRID = dict(pattern=("mamba", "attn"), n_heads=2, n_kv_heads=1,
              head_dim=16, d_ff=64, kv_chunk=32)


def _model(hybrid=False, quant=False):
    kw = HYBRID if hybrid else {}
    jcfg = jax_get_smoke("mamba2_780m").replace(dtype=jnp.float32, **kw)
    cfg = get_smoke("mamba2-780m").replace(dtype=torch.float32, **kw)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    if quant:
        jparams = jax_quantize(jcfg, jparams)
        params = quantize_model_params(cfg, params)
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def models():
    return {(h, q): _model(h, q) for h, q in ((False, False), (False, True),
                                              (True, False))}


def _prompts(seed, lengths, prefix_len=0, vocab=256):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=prefix_len).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, size=n)
                            .astype(np.int32)]) for n in lengths]


# (ServeConfig fields, quantized, prompts, max_new)
MODES = {
    "padded_prefill": (dict(max_slots=2, max_len=48, buckets=(8, 16),
                            tick_steps=3), False, _prompts(1, (3, 6, 11)), 5),
    "paged": (dict(max_slots=2, max_len=48, buckets=(8, 16), tick_steps=3,
                   paged=True, page_len=8), False, _prompts(1, (3, 6, 11)),
              5),
    "prefix_hit_snapshot": (dict(max_slots=1, max_len=64,
                                 buckets=(8, 16, 32), tick_steps=3,
                                 paged=True, page_len=8, prefix_cache=True,
                                 chunked="always", chunk_len=8), False,
                            _prompts(5, (5, 4, 6), prefix_len=16), 6),
    "chunked_auto": (dict(max_slots=3, max_len=64, buckets=(8, 16),
                          tick_steps=3, chunked="auto"), False,
                     _prompts(1, (3, 7, 8, 9, 17, 30, 44)), 5),
    "chunked_always": (dict(max_slots=3, max_len=64, buckets=(8, 16),
                            tick_steps=3, chunked="always"), False,
                       _prompts(1, (3, 7, 8, 9, 17, 30, 44)), 5),
    # a page-aligned 16-token prompt admitted through its bucket leaves a
    # snapshot at admission; the next two hit it
    "bucketed_snapshot": (dict(max_slots=1, max_len=64, buckets=(8, 16),
                               tick_steps=3, paged=True, page_len=8,
                               prefix_cache=True, chunked="auto",
                               chunk_len=8), False,
                          _prompts(6, (0, 5, 3), prefix_len=16), 5),
    # a page-aligned prompt ingested in chunks: its last chunk lands on
    # the boundary, so its row sits out that tick's decode for the snapshot
    "deferred_snapshot": (dict(max_slots=1, max_len=64, buckets=(8, 16),
                               tick_steps=3, paged=True, page_len=8,
                               prefix_cache=True, chunked="always",
                               chunk_len=8), False,
                          _prompts(8, (0, 5, 3), prefix_len=16), 5),
    "paged_quant_stats": (dict(max_slots=2, max_len=64, buckets=(8, 16),
                               tick_steps=3, paged=True, page_len=8,
                               prefix_cache=True, chunked="auto",
                               chunk_len=8, quant="xla", with_stats=True),
                          True, _prompts(7, (2, 9, 11, 3), prefix_len=16), 4),
}


def _run_both(model, kw, prompts, max_new):
    jcfg, jparams, cfg, params = model
    ref = _drive(JaxScheduler(jcfg, jparams, JaxServeConfig(**kw)),
                 prompts, max_new)
    sched = ServeScheduler(cfg, params, ServeConfig(**kw), device="cpu")
    return ref, _drive(sched, prompts, max_new), sched


@pytest.mark.parametrize("mode", list(MODES))
def test_mamba_scheduler_matches_reference(models, mode):
    kw, quant, prompts, max_new = MODES[mode]
    ref, ours, sched = _run_both(models[(False, quant)], kw, prompts,
                                 max_new)
    _compare(ref, ours)
    results = ours[2]
    assert all(r.finish_reason == "length" and len(r.tokens) == max_new
               for r in results)
    if kw.get("prefix_cache"):
        st = sched.prefix_cache_stats()
        assert st["lookup_hits"] == 2 and st["cached_tokens"] == 32, st
        assert sched._radix._n_snapshots >= 1
    if kw.get("with_stats"):
        assert all(0 < r.plane_traffic_fraction <= 1 for r in results)


def test_hybrid_paged_prefix_kernel_matches_reference(models):
    """``("mamba", "attn")`` on a paged pool with the prefix cache and the
    paged-attention kernel (its plain version here, interpret mode in the
    reference): attention pages are aliased while the mamba layers
    restore the snapshot; a prefix that ends inside a page hits only the
    whole pages (no copy on write with recurrent state)."""
    kw = dict(max_slots=2, max_len=64, buckets=(8, 16), tick_steps=3,
              paged=True, page_len=8, prefix_cache=True, chunked="auto",
              chunk_len=8, attn_kernel="pallas", attn_splits=2)
    prompts = _prompts(9, (5, 3, 7, 4), prefix_len=19)
    ref, ours, sched = _run_both(models[(True, False)], kw, prompts, 5)
    _compare(ref, ours)
    assert all(len(r.tokens) == 5 for r in ours[2])
    st = sched.prefix_cache_stats()
    assert st["lookup_hits"] >= 1 and st["cached_tokens"] % 8 == 0, st


def test_cli_serves_mamba_on_the_host(capsys):
    """``launch.serve --arch mamba2-780m --smoke`` one-shot (quantized on
    packed planes) and ``--continuous --paged --prefix-cache``; a
    ``--kv-quant`` on this attention-free model is refused."""
    from repro_torch.launch import serve

    base = ["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
            "--new-tokens", "4", "--prompt-len", "8"]
    serve.main(base + ["--batch", "2", "--quant", "--pack"])
    results = serve.main(base + ["--continuous", "--paged", "--prefix-cache",
                                 "--page-len", "4", "--requests", "5",
                                 "--max-slots", "2"])
    out = capsys.readouterr().out
    assert "plane_traffic_fraction" in out and "prefix cache:" in out
    assert len(results) == 5 and all(len(r.tokens) == 4 for r in results)
    with pytest.raises(SystemExit):
        serve.main(base + ["--continuous", "--kv-quant", "4"])
    assert "no attention layer" in capsys.readouterr().err
