"""Bit-equality across ranks on the CPU: every quantized projection's
int32 output, and the paged-attention split-KV walk spread over the model
axis, against the one-rank call; and a failing rank fails the whole local
group at once, within its timeout.

* **Projections** (packed planes, the smoke configs of
  ``test_torch_tp_serve.py`` at M = 2 and 4): K2's int32 product is exact
  in any order, so a column-parallel rank's outputs are the one-rank
  call's columns, and a row-parallel rank's partials sum to it before the
  float epilogue.  The reference's rules keep mamba's ``wz``/``wx``
  planes whole, so mamba has no column-parallel projection.
* **Split-KV** (case B of ``kernels/paged_attention/ops.py``: the heads do
  not divide the ranks): ``attn_splits`` 4 over 2 and 4 ranks, each rank
  walking its run of splits with K3's and K4's plain versions, the
  partials gathered along the split axis and merged: bit-equal to the
  one-rank call with the same splits, at smollm-135m's geometry
  (3 kv heads, 3 q heads a group, head dim 64).

Also: the expert-parallel dispatch against the one-rank dispatch (kept
slots, rows, dropped counts); the refusal of the reference's all_to_all
EP branch.  ``test_torch_tp_configs.py`` runs the other six configs on
ranks.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_smoke
from repro_torch.core.logquant import code_dtype
from repro_torch.core.shiftadd import QuantCtx
from repro_torch.kernels.paged_attention import ops
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding as sh
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import forward
from repro_torch.models.quantize import quantize_model_params

ARCHS = {"smollm-135m": "smollm_135m", "qwen3-32b": "qwen3_32b",
         "deepseek-moe-16b": "deepseek_moe_16b", "mamba2-780m": "mamba2_780m"}


@pytest.fixture(scope="module", params=list(ARCHS))
def quantized(request):
    arch = request.param
    cfg = get_smoke(arch).replace(dtype=torch.float32)
    jparams = jax_init_params(jax.random.PRNGKey(0), jax_get_smoke(
        ARCHS[arch]).replace(dtype=jnp.float32))
    params = quantize_model_params(cfg, params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu"), pack=True)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    return arch, cfg, params, prompt


def _int32_outputs(cfg, params, prompt):
    ctx = QuantCtx(capture=[])
    forward(cfg, params, tokens=prompt, quant=ctx)
    return [(c[0].shape[-1], c[4]) for c in ctx.capture]


@pytest.mark.parametrize("m", [2, 4])
def test_quantized_projections_int32_bit_equal(quantized, m):
    arch, cfg, params, prompt = quantized
    want = _int32_outputs(cfg, params, prompt)
    mesh = Mesh((1, m), sh.LocalGroup(m, timeout=120))
    specs = shardings.params_shardings(mesh, params, fsdp=False,
                                       kv_heads=cfg.n_kv_heads)
    per_rank = mesh.run(lambda r: _int32_outputs(
        cfg, shardings.shard_params(params, specs, mesh, r), prompt))
    kinds = set()
    for i, (k, y) in enumerate(want):
        got = [r[i] for r in per_rank]
        if got[0][1].shape[-1] < y.shape[-1]:           # column-parallel
            out, kind = torch.cat([g[1] for g in got], -1), "column"
        elif got[0][0] < k:                             # row-parallel
            out, kind = got[0][1], "row"
            for g in got[1:]:
                out = out + g[1]
        else:                                           # replicated
            assert all(torch.equal(g[1], y) for g in got), i
            out, kind = got[0][1], "replicated"
        assert out.dtype == torch.int32 and torch.equal(out, y), (i, kind)
        kinds.add(kind)
    assert "row" in kinds
    assert ("column" in kinds) == (arch != "mamba2-780m")


def _pools(quant, g=3, r=3, d=64, page_len=8, nb=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([61, 9, 0, 33], dtype=torch.int32)
    table = torch.from_numpy(ops.make_page_table(lengths.numpy(), nb,
                                                 page_len))
    n_pages = int(table.max()) + 1
    b = lengths.shape[0]
    q = torch.randn((b, 1, g * r, d), generator=gen)
    if not quant:
        kv = [torch.randn((n_pages, page_len, g, d), generator=gen)
              for _ in range(2)]
        return q, kv, table, lengths
    ct = code_dtype(4)
    codes = [torch.randint(-100, 100, (n_pages, page_len, g, d),
                           generator=gen).to(ct) for _ in range(2)]
    scales = [torch.randint(-3, 4, (n_pages, g), generator=gen,
                            dtype=torch.int32) for _ in range(2)]
    tails = [torch.randn((b, 2 * page_len + 1, g, d), generator=gen)
             for _ in range(2)]
    return q, (codes[0], scales[0], codes[1], scales[1], *tails), table, \
        lengths


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["k3", "k4"])
def test_split_kv_across_ranks_bit_equal(quant, m):
    q, pools, table, lengths = _pools(quant)
    attend = (ops.paged_decode_attention_quant if quant
              else ops.paged_decode_attention)
    want = attend(q, *pools, table, lengths, splits=4)
    mesh = Mesh((1, m), sh.LocalGroup(m, timeout=120))

    def rank(r):
        runs = ops.rank_runs(table, lengths, 8, 4)
        assert runs[0].shape[1] == 8 // m and runs[2] == 4 // m
        return attend(q, *pools, table, lengths, splits=4, spread=True)
    for got in mesh.run(rank):
        assert torch.equal(got, want)
    # 3 splits do not divide the ranks: every rank walks them all
    three = attend(q, *pools, table, lengths, splits=3)
    for got in mesh.run(lambda r: attend(q, *pools, table, lengths,
                                         splits=3, spread=True)):
        assert torch.equal(got, three)


@pytest.mark.parametrize("m", [2, 4])
def test_expert_parallel_drops_sum_to_local(m):
    """Each rank keeps exactly the one-rank dispatch's slots of its
    experts, at the same buffer rows less its offset, and the ranks'
    dropped slots sum to the one-rank count."""
    from repro_torch.models import moe

    gen = torch.Generator().manual_seed(m)
    e, cap = 8, 3
    ids = torch.randint(0, e, (40,), generator=gen, dtype=torch.int32)
    order, dest, keep = moe._dispatch_tables(ids, e, cap)
    drops, kept = 0, torch.zeros_like(keep)
    for r in range(m):
        o, d, mine, dropped = moe.ep_tables(ids, e, cap, r, m)
        assert torch.equal(o, order)
        lo = r * (e // m) * cap
        assert torch.equal(d[mine], dest[mine] - lo)
        assert bool((d[~mine] == (e // m) * cap).all())
        kept |= mine
        drops += int(dropped)
    assert torch.equal(kept, keep) and drops == int((~keep).sum()) > 0


def test_moe_all_to_all_branch_is_refused():
    """With the sequence split over the expert axis the reference takes
    its all_to_all branch (training's layouts); the port raises there."""
    from repro_torch.models.model import init_params
    from repro_torch.models.moe import moe_apply

    cfg = get_smoke("deepseek-moe-16b").replace(dtype=torch.float32)
    mlp = init_params(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")["blocks"][0]["mlp"]
    layer = {"router": mlp["router"][0],
             "experts": {k: v[0] for k, v in mlp["experts"].items()}}
    mesh = Mesh((1, 2), sh.LocalGroup(2, timeout=60))

    def rank(r):
        with sh.mesh_axes(mesh=mesh, seq_shard=True):
            moe_apply(layer, torch.zeros((1, 4, cfg.d_model)), cfg)
    with pytest.raises(NotImplementedError, match="all_to_all"):
        mesh.run(rank)


def test_failing_rank_fails_the_group_at_once():
    group = sh.LocalGroup(4, timeout=60)
    mesh = Mesh((1, 4), group)

    def rank(r):
        if r == 2:
            raise ValueError("rank 2 broke")
        return sh.all_reduce(torch.ones(3))

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 2 broke"):
        mesh.run(rank)
    assert time.perf_counter() - t0 < 10
    # a rank that ends early fails the others' next collective
    with pytest.raises(RuntimeError, match="ended before collective"):
        mesh.run(lambda r: None if r == 1 else sh.all_gather(
            torch.ones(2), 0))
    # a turn that does not come within the timeout fails every rank
    slow = Mesh((1, 2), sh.LocalGroup(2, timeout=0.3))

    def stall(r):
        if r == 1:
            time.sleep(1.0)
        return sh.all_reduce(torch.ones(1))

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="within 0.3 s"):
        slow.run(stall)
    assert time.perf_counter() - t0 < 10
    # the group is reusable after a failure
    assert [t.tolist() for t in mesh.run(
        lambda r: sh.all_reduce(torch.full((2,), float(r))))] \
        == [[6.0, 6.0]] * 4
