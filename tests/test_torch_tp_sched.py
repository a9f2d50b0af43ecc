"""The continuous-batching scheduler on the model axis held against the
JAX package's single-device scheduler, on the CPU at f32: the smoke
configs of smollm here (one kv head: attention replicated, K3/K4's
split-KV runs spread over the ranks) and deepseek-moe in
``test_torch_tp_sched_moe.py`` (four kv heads: the pool holds each rank's
heads; the 8 routed experts expert-parallel), as M = 2 and M = 4 ranks of
a local group, through the paged pool with the plain
K3 (float) and through the log2-quantized pool with the plain K4
(quantized projections with stats), ``attn_splits`` 4, the prefix cache
and chunked prefill on.

Every rank builds its own scheduler from its shard of the params and
drives the same trace (``test_torch_scheduler.py``'s, tick by tick); each
rank's log equals the reference's: the return of every tick, the
lengths, page tables, refcounts, free list, radix size and prefix stats
after it, and every request's tokens, finish reason and ticks.
Per-request element-granular traffic fractions agree within 1e-6; the
tile-granular ones are not compared (no rank's K slice is a multiple of
K2's 128-row tile at these widths).  The CLI serves the same tokens
with ``--mesh 1x2 --host-devices 2`` as without, quantized: there every
sum across ranks is exact (the CLI's bf16 float path rounds the
row-parallel partials of ``down`` before their sum).
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
from repro_torch.launch import serve, shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding as sh
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.quantize import quantize_model_params
from repro_torch.serving import ServeConfig, ServeScheduler
from test_torch_scheduler import _drive, _prompts, _result

PAGED = dict(max_slots=3, max_len=64, buckets=(8, 16), tick_steps=4,
             paged=True, page_len=4, prefix_cache=True, chunked="auto",
             chunk_len=8, attn_kernel="pallas", attn_splits=4)
MODES = {"k3": (dict(PAGED), False),
         "k4": (dict(PAGED, kv_quant=True, quant="xla", with_stats=True),
                True)}
ARCHS = {"smollm-135m": "smollm_135m", "deepseek-moe-16b": "deepseek_moe_16b"}

_REF = {}


@pytest.fixture(scope="module")
def reference():
    """``(cfg, params, reference log)`` per (arch, mode), built once."""
    def get(arch, mode):
        if (arch, mode) not in _REF:
            kw, quant = MODES[mode]
            jcfg = jax_get_smoke(ARCHS[arch]).replace(dtype=jnp.float32)
            cfg = get_smoke(arch).replace(dtype=torch.float32)
            jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
            params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                       device="cpu")
            if quant:
                jparams = jax_quantize(jcfg, jparams)
                params = quantize_model_params(cfg, params)
            ref = _drive(JaxScheduler(jcfg, jparams, JaxServeConfig(**kw)),
                         _prompts(), 6)
            _REF[arch, mode] = (cfg, params, ref)
        return _REF[arch, mode]
    yield get
    _REF.clear()


def _compare(ref, ours):
    (jrids, jlog, jres), (rids, log, res) = ref, ours
    assert rids == jrids and len(log) == len(jlog)
    for t, (a, b) in enumerate(zip(jlog, log)):
        assert a == b, f"tick {t}"
    assert [_result(r) for r in res] == [_result(r) for r in jres]
    for a, b in zip(jres, res):
        x, y = a.element_traffic_fraction, b.element_traffic_fraction
        assert (np.isnan(x) and np.isnan(y)) or abs(x - y) <= 1e-6


def check_scheduler_on_ranks(reference, arch, mode, m):
    """Each of ``m`` ranks drives the trace through its own scheduler; each
    rank's log equals the reference's."""
    cfg, params, ref = reference(arch, mode)
    kw, _ = MODES[mode]
    mesh = Mesh((1, m), sh.LocalGroup(m, timeout=120))
    specs = shardings.params_shardings(mesh, params, fsdp=False,
                                       kv_heads=cfg.n_kv_heads)

    def rank(r):
        sched = ServeScheduler(cfg, shardings.shard_params(params, specs,
                                                           mesh, r),
                               ServeConfig(**kw), device="cpu", mesh=mesh)
        layer = sched._pool["layers"][0]
        pool = layer["k_codes" if "k_codes" in layer else "k"]
        return _drive(sched, _prompts(), 6), pool.shape[-2]

    for ours, heads in mesh.run(rank):
        _compare(ref, ours)
        # the pool holds the rank's kv heads (all of them when they do
        # not divide the ranks)
        g = cfg.n_kv_heads
        assert heads == (g // m if g % m == 0 else g)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_scheduler_on_ranks_matches_reference(reference, mode, m):
    check_scheduler_on_ranks(reference, "smollm-135m", mode, m)


def test_cli_mesh_serves_the_single_card_tokens(capsys):
    flags = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
             "--continuous", "--paged", "--page-len", "4", "--prompt-len",
             "8", "--requests", "6", "--new-tokens", "6", "--attn-kernel",
             "--attn-splits", "2", "--quant"]
    one = serve.main(flags)
    out_one = capsys.readouterr().out
    two = serve.main(flags + ["--mesh", "1x2", "--host-devices", "2"])
    out_two = capsys.readouterr().out
    assert [r.tokens for r in one] == [r.tokens for r in two]

    def sample(out):
        return [ln for ln in out.splitlines() if ln.startswith("sample")]
    assert sample(out_one) == sample(out_two) and len(sample(out_two)) == 1
    assert "(1x2 mesh, local group" in out_two
    with pytest.raises(NotImplementedError, match="page allocator"):
        serve.main(flags + ["--mesh", "2x1", "--host-devices", "2"])
    with pytest.raises(SystemExit, match="router is not sharded"):
        serve.main(flags + ["--mesh", "1x2", "--host-devices", "2",
                            "--disaggregate"])
