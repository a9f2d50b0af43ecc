"""The port's partition rules held against the JAX package's, with no
ranks: ``param_spec`` leaf for leaf on all ten configs at full size (the
reference's trees through ``jax.eval_shape``, float and packed quantized;
the port's float trees on the ``meta`` device) on the 1x2, 1x4, 2x2 and
4x1 meshes, ``cache_shardings``, ``split_kv_specs``, ``serve_shardings``,
``spec_for``, ``for_cell`` and the mesh builders.

The reference needs a live mesh for ``NamedSharding`` only; its rules
read ``mesh.shape`` and ``mesh.axis_names``, so it is called with a
stand-in that has those, and ``NamedSharding`` is patched to return the
spec.  The one intended difference (``launch/shardings.py``): the port
shards attention at head granularity only, so the attention leaves of a
model whose kv heads do not divide the model axis stay replicated; the
test names those leaves.
"""

import re
import types
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.launch import policy as jax_policy
from repro.launch import shardings as jax_sh
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import sharding as jax_hints
from repro.models.model import init_paged_pool as jax_init_pool
from repro.models.quantize import quantize_model_params as jax_quantize
from repro_torch import tree as tree_util
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.launch import host_devices, mesh as mesh_mod, policy
from repro_torch.launch import shardings
from repro_torch.models import sharding as sh
from repro_torch.models.model import init_caches, init_params

MESHES = [(1, 2), (1, 4), (2, 2), (4, 1)]
_ATTN = ["['wk']", "['wk_q'].planes", "['wo']", "['wo_q'].planes", "['wq']",
         "['wq_q'].planes", "['wv']", "['wv_q'].planes"]
# (config, model-axis size) -> the leaves (block index dropped) where the
# port's head-granular rule keeps attention replicated and the
# reference's flat H*hd rule shards it
HEAD_DIFFS = {("smollm_135m", 2): _ATTN, ("smollm_135m", 4): _ATTN,
              ("qwen3-smoke", 4): _ATTN}


def _stand_in(d, m):
    return types.SimpleNamespace(shape={"data": d, "model": m},
                                 axis_names=("data", "model"), size=d * m)


class _Spec:
    """A reference spec as a tree leaf (a tuple would be a tree node)."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture
def spec_only(monkeypatch):
    """The reference's rules return their ``PartitionSpec`` unplaced."""
    monkeypatch.setattr(jax_sh, "NamedSharding", _Spec)


def _trees(jcfg):
    tree = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    packed = jax.eval_shape(lambda t: jax_quantize(jcfg, t, pack=True), tree)
    return tree, packed


def _diffs(jcfg, kv_heads, trees, d, m, fsdp=()):
    mesh = _stand_in(d, m)
    out = set()
    for t in trees:
        for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
            k = jax.tree_util.keystr(path)
            theirs = tuple(jax_sh.param_spec(k, leaf.shape, mesh,
                                             fsdp_axes=fsdp))
            ours = shardings.param_spec(k, tuple(leaf.shape), mesh,
                                        fsdp_axes=fsdp, kv_heads=kv_heads)
            if theirs != ours:
                out.add(re.sub(r"\['blocks'\]\[\d+\]", "", k))
    return sorted(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference_full_size(arch):
    jcfg = jax_get_config(arch)
    cfg = get_config(arch)
    trees = _trees(jcfg)
    # the port's float tree has the reference's paths and shapes
    ours = [(p, tuple(t.shape)) for p, t in tree_util.flatten_with_path(
        init_params(cfg, device="meta"))]
    theirs = [(jax.tree_util.keystr(p), tuple(leaf.shape)) for p, leaf in
              jax.tree_util.tree_flatten_with_path(trees[0])[0]]
    assert ours == theirs
    for d, m in MESHES:
        assert _diffs(jcfg, cfg.n_kv_heads, trees, d, m) \
            == HEAD_DIFFS.get((arch, m), []), (d, m)
    # the FSDP branch (training's layouts) on the 2x2 mesh
    assert _diffs(jcfg, cfg.n_kv_heads, trees, 2, 2, fsdp=("data",)) \
        == HEAD_DIFFS.get((arch, 2), [])


def test_param_spec_head_granularity_on_smoke_configs():
    """The serving tests' config qwen3 smoke: its two kv heads divide 2
    ranks but not 4, where the reference still splits the 64-wide q dim
    and the 32-wide k/v dims."""
    jcfg = jax_get_smoke("qwen3_32b")
    trees = _trees(jcfg)
    assert _diffs(jcfg, 2, trees, 1, 2) == []
    assert _diffs(jcfg, 2, trees, 1, 4) == HEAD_DIFFS[("qwen3-smoke", 4)]


def test_params_shardings_tree_and_shard_params():
    """The spec tree follows the params tree, and ``shard_params`` cuts
    each sharded leaf into contiguous runs that concatenate back to it;
    replicated leaves are the full tree's own tensors."""
    cfg = get_smoke("deepseek-moe-16b").replace(dtype=torch.float32)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    mesh = mesh_mod.Mesh((1, 4))
    specs = shardings.params_shardings(mesh, params, fsdp=False,
                                       kv_heads=cfg.n_kv_heads)
    flat = tree_util.flatten_with_path(params)
    spec_list = shardings.spec_leaves(params, specs)
    shards = [tree_util.leaves(shardings.shard_params(params, specs, mesh, r))
              for r in range(4)]
    assert len(spec_list) == len(flat)
    for i, ((path, full), spec) in enumerate(zip(flat, spec_list)):
        if "model" not in spec:
            assert all(s[i] is full for s in shards), path
            continue
        dim = spec.index("model")
        assert all(s[i].is_contiguous() for s in shards)
        assert torch.equal(torch.cat([s[i] for s in shards], dim), full), \
            path
    with pytest.raises(NotImplementedError, match="model axis only"):
        shardings.shard_params(params, shardings.params_shardings(
            mesh_mod.Mesh((2, 2)), params, fsdp=True, fsdp_threshold=1),
            mesh_mod.Mesh((2, 2)), 0)


@pytest.mark.parametrize("where", ["outside", "1x2"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-780m"])
def test_shard_outside_its_mesh_raises(arch, where):
    """A rank's widths are read against the scope: a shard cut for four
    ranks, run on one device or on two ranks, raises instead of computing
    a part of the model's function."""
    from repro_torch.models.model import forward

    cfg = get_smoke(arch).replace(dtype=torch.float32)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    mesh = mesh_mod.Mesh((1, 4))
    specs = shardings.params_shardings(mesh, params, fsdp=False,
                                       kv_heads=cfg.n_kv_heads)
    shard = shardings.shard_params(params, specs, mesh, 0)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="neither the whole dim"):
        if where == "outside":
            forward(cfg, shard, tokens=tokens)
        else:
            mesh_mod.Mesh((1, 2), sh.LocalGroup(2)).run(
                lambda r: forward(cfg, shard, tokens=tokens))


@pytest.mark.parametrize("kind", ["dense", "paged", "kv_quant"])
@pytest.mark.parametrize("d,m", MESHES)
def test_cache_shardings_match_reference(spec_only, kind, d, m):
    jcfg = jax_get_smoke("jamba_v01_52b").replace(dtype=jnp.float32)
    cfg = get_smoke("jamba-v0.1-52b").replace(dtype=torch.float32)
    if kind == "dense":
        jtree = jax.eval_shape(lambda: jax_init_caches(
            jcfg, 4, 64, dtype=jnp.float32, per_slot=True))
        tree = init_caches(cfg, 4, 64, device="meta", per_slot=True)
    else:
        q = kind == "kv_quant"
        jtree = jax.eval_shape(lambda: jax_init_pool(
            jcfg.replace(kv_quant=q), 4, 64, 33, 8, dtype=jnp.float32))
        from repro_torch.models.model import init_paged_pool
        tree = init_paged_pool(cfg.replace(kv_quant=q), 4, 64, 33, 8,
                               device="meta")
    mesh = _stand_in(d, m)
    for long_context in (False, True):
        theirs = jax_sh.cache_shardings(mesh, jtree, batch=4,
                                        paged=kind != "dense",
                                        long_context=long_context)
        ours = shardings.cache_shardings(mesh, tree, batch=4,
                                         paged=kind != "dense",
                                         long_context=long_context)
        jflat = jax.tree_util.tree_flatten_with_path(
            theirs, is_leaf=lambda x: isinstance(x, _Spec))[0]
        want = {jax.tree_util.keystr(p): s.spec for p, s in jflat}
        got = dict(zip([p for p, _ in tree_util.flatten_with_path(tree)],
                       shardings.spec_leaves(tree, ours)))
        assert got == want


@pytest.mark.parametrize("d,m", MESHES)
@pytest.mark.parametrize("splits,batch", [(1, 4), (2, 4), (4, 3), (8, 2)])
def test_split_kv_and_serve_specs_match_reference(spec_only, d, m, splits,
                                                  batch):
    mesh = _stand_in(d, m)
    theirs = jax_sh.split_kv_specs(mesh, splits=splits, batch=batch)
    ours = shardings.split_kv_specs(mesh, splits=splits, batch=batch)
    assert {k: tuple(v) for k, v in theirs.items()} == ours
    jcfg = jax_get_smoke("smollm_135m").replace(dtype=jnp.float32)
    jp = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                jcfg))
    jc = jax.eval_shape(lambda: jax_init_caches(jcfg, batch, 32,
                                                per_slot=True))
    js = jax_sh.serve_shardings(mesh, jp, jc, batch=batch)
    os_ = shardings.serve_shardings(mesh, jp, jc, batch=batch)
    for key in ("logits", "tokens", "active", "replicated"):
        assert js[key].spec == os_[key], key


SHAPES = {"btd": [(4, 8, 6), (3, 5, 6)], "btf": [(4, 8, 12), (4, 8, 6)],
          "bthd": [(4, 8, 8, 2), (2, 3, 3, 2)], "btv": [(4, 1, 256)],
          "ecd": [(8, 3, 4), (6, 3, 4)], "bshp": [(4, 8, 4, 2)],
          "bchll": [(4, 2, 4, 3, 3)], "bchpn": [(2, 2, 8, 4, 4)],
          "cache": [(4, 16, 2, 8), (1, 16, 2, 8)],
          "pool": [(12, 4, 2, 8), (9, 4, 2, 8)],
          "kvsplit": [(4, 2, 4, 3, 8), (3, 2, 3, 3, 8)],
          "kvsplit_stat": [(4, 2, 4, 3)], "btc": [(4, 8, 6)]}


@pytest.mark.parametrize("d,m", MESHES)
@pytest.mark.parametrize("seq_shard", [False, True])
def test_spec_for_every_kind_matches_reference(d, m, seq_shard):
    sizes = {"data": d, "model": m}
    for kind, shapes in SHAPES.items():
        for shape in shapes:
            for force in (False, True):
                with jax_hints.mesh_axes(sizes=sizes, seq_shard=seq_shard):
                    theirs = jax_hints.spec_for(kind, shape, force=force)
                with sh.mesh_axes(sizes=sizes, seq_shard=seq_shard):
                    ours = sh.spec_for(kind, shape, force=force)
                assert (None if theirs is None else tuple(theirs)) == ours, \
                    (kind, shape, force)
    assert sh.spec_for("btd", (4, 8, 6)) is None      # outside a scope
    with pytest.raises(ValueError, match="unknown sharding kind"):
        with sh.mesh_axes(sizes=sizes):
            sh.spec_for("nope", (1,))


@pytest.mark.parametrize("arch", ["qwen3_32b", "deepseek_moe_16b"])
@pytest.mark.parametrize("layout", [None, "tp", "fsdp", "ep", "ep_dp"])
@pytest.mark.parametrize("step,batch", [("serve", None), ("train", 16),
                                        ("train", 6)])
def test_for_cell_matches_reference(arch, layout, step, batch):
    mesh = _stand_in(2, 4)
    theirs = jax_policy.for_cell(jax_get_config(arch), step, mesh,
                                 override=layout, global_batch=batch)
    ours = policy.for_cell(get_config(arch), step, mesh, override=layout,
                           global_batch=batch)
    assert vars(ours) == vars(theirs)
    assert ours.describe() == theirs.describe()


def test_mesh_builders():
    """The reference's warning and errors (``tests/test_serve_sharded.py``
    ``TestMeshBuilders``), the TPU pods' refusal, ``--host-devices``
    parsing, and the serving path's refusal of a data axis."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m = mesh_mod.make_host_mesh(4)
    assert m.shape == {"data": 1, "model": 1} and m.group is None
    assert any("falling back" in str(x.message) for x in w)
    with pytest.raises(ValueError, match="expected"):
        mesh_mod.make_serve_mesh("2by2")
    with pytest.raises(ValueError, match="needs 16 devices"):
        mesh_mod.make_serve_mesh("4x4")
    for pod in ("pod", "pod2"):
        with pytest.raises(ValueError, match="TPU v5e pod"):
            mesh_mod.make_serve_mesh(pod)

    assert host_devices.force_host_devices(["x", "--host-devices", "8"]) == 8
    assert host_devices.force_host_devices(["--host-devices=4"]) == 4
    assert host_devices.force_host_devices(["--arch", "a"]) is None
    with pytest.raises(ValueError, match="at least one rank"):
        host_devices.force_host_devices(["--host-devices=0"])
    assert host_devices.visible_ranks() == 1      # parsing selects nothing
    with pytest.raises(ValueError, match="8 devices"):
        mesh_mod.make_host_mesh(3, group=sh.LocalGroup(8))
    m = mesh_mod.make_serve_mesh("host", 2, group=sh.LocalGroup(4))
    assert m.shape == {"data": 2, "model": 2}
    assert isinstance(m.group, sh.LocalGroup) and m.group.size == 4
    m14 = mesh_mod.make_serve_mesh("1x4", group=sh.LocalGroup(4))
    assert m14.shape == {"data": 1, "model": 4} and m14.group.size == 4
    assert mesh_mod.make_serve_mesh("1x1", group=sh.LocalGroup(4)).group \
        is None
    assert mesh_mod.batch_axes(m) == ("data",)
    with pytest.raises(NotImplementedError, match="page allocator"):
        mesh_mod.check_serving(m)
    with pytest.raises(RuntimeError, match="inside mesh.run"):
        mesh_mod.check_serving(m14)
    assert m14.run(lambda r: (r, sh.model_rank(), sh.model_size())) \
        == [(r, r, 4) for r in range(4)]
    # a config's mesh_spec resolves to the mesh of the rank's scope
    from repro_torch.serving.config import ServeConfig
    assert m14.run(lambda r: ServeConfig(mesh_spec="1x4").make_mesh()) \
        == [m14] * 4
    with pytest.raises(ValueError, match="inside the scope of a 1x4 mesh"):
        m14.run(lambda r: ServeConfig(mesh_spec="1x2").make_mesh())


@pytest.mark.parametrize("extra, match", [
    (["--mesh", "1x4"], "4 ranks, one a card"),
    (["--mesh", "pod"], "needs --mesh host or DxM"),
    ([], "needs --mesh host or DxM"),
    (["--mesh", "1x2", "--host-devices", "2"], "choose one group"),
])
def test_nccl_cli_refuses_what_the_cards_cannot_hold(extra, match):
    """``--nccl`` spawns one process per rank of the mesh, one a card: a
    mesh without a size, or larger than the visible cards, is refused
    before anything is built."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match=match):
        serve.main(["--arch", "smollm-135m", "--smoke", "--nccl", *extra])

