"""The training substrate of the port held against the JAX package:
AdamW (``optim/adamw.py``), the synthetic data (``data/pipeline.py``),
checkpoints (``checkpoint/manager.py``), the straggler watchdog and the
tree helpers (``repro_torch/tree.py``).

AdamW is fed the same gradients as the reference's jitted ``update`` for
12 steps over a tree of f32 and bf16 leaves: ``lr`` within 1e-6 relative
(the two cosines differ by an ulp at some steps), ``grad_norm`` within
2e-6 relative (the f32 sums group alike but XLA reduces each leaf in
another order), moments and params within rtol 1e-6, atol 1e-7 for f32
(XLA turns ``mh / (sqrt(vh) + eps)`` into other float steps; measured
3.0e-8 on params) and within one bf16 rounding for bf16.  Data batches
are bit-equal.  A checkpoint written by either package restores in the
other, bf16 leaves through f32 included, leaf for leaf equal.
``tests/test_substrate.py``'s own cases run on the port as written there.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim import adamw
from repro_torch.train.trainer import StragglerWatchdog
from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp_np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def test_tree_order_and_paths_are_jax_s():
    rng = np.random.default_rng(0)
    tree = {"z": (rng.random(2), {"b": rng.random(1), "a": rng.random(3)}),
            "a": [rng.random(4)], "m": None, "k": {"y": rng.random(5)}}
    want = [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = flatten_with_path(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(g is x for (_, g), x in zip(got, jax.tree.leaves(tree)))
    back = unflatten(tree, leaves(tree))
    assert list(back) == list(tree) and back["m"] is None
    assert isinstance(back["z"], tuple) and isinstance(back["a"], list)
    with pytest.raises(ValueError):
        tree_map(lambda a, b: a, tree, {"a": [1]})


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _draw(rng, scale):
    return {"w": (rng.standard_normal((7, 5)) * scale).astype(np.float32),
            "blocks": ({"up": (rng.standard_normal((4, 6)) * scale
                               ).astype(np.float32),
                        "ln": (rng.standard_normal(6) * scale
                               ).astype(np.float32)},),
            "b": (rng.standard_normal(3) * scale).astype(np.float32)}


def test_update_matches_reference():
    rng = np.random.default_rng(1)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=12)
    jcfg, cfg = jax_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    p0 = _draw(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, p0)
    jp["blocks"] = ({**jp["blocks"][0],
                     "up": jp["blocks"][0]["up"].astype(jnp.bfloat16)},)
    tp = tree_map(torch.from_numpy, p0)
    tp["blocks"][0]["up"] = tp["blocks"][0]["up"].bfloat16()
    js, ts = jax_adamw.init(jp), adamw.init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    assert all(m.dtype == torch.float32 for m in leaves(ts["m"]))
    upd = jax.jit(lambda g, s, p: jax_adamw.update(jcfg, g, s, p))
    for i in range(12):
        g = _draw(rng, 3.0 if i % 3 == 0 else 0.05)     # clipped, then not
        jp, js, jm = upd(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = adamw.update(cfg, tree_map(torch.from_numpy, g), ts, tp)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(
            jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            2e-6 * float(jm["grad_norm"])
        for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]),
                               (ts["v"], js["v"])):
            for (key, t), j in zip(flatten_with_path(tree_t),
                                   jax.tree.leaves(tree_j)):
                assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16
                                   else torch.float32), key
                if t.dtype == torch.bfloat16:
                    np.testing.assert_allclose(_np(t), _jnp_np(j),
                                               rtol=2 ** -8, atol=1e-6,
                                               err_msg=key)
                else:
                    np.testing.assert_allclose(_np(t), _jnp_np(j),
                                               rtol=1e-6, atol=1e-7,
                                               err_msg=key)


def test_schedule_matches_reference():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=5, total_steps=20),
               dict(lr=2e-3, warmup_steps=0, total_steps=7)):
        jcfg, cfg = jax_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
        for s in range(0, kw["total_steps"] + 3):
            want = float(jax_adamw.schedule(jcfg, jnp.asarray(s)))
            got = adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-6 * abs(want), (kw, s)


def test_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                            total_steps=200)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    state = adamw.init(params)
    target = torch.tensor([1.0, 1.0, 1.0])
    for _ in range(150):
        g = {"w": 2 * (params["w"] - target)}
        params, state, metrics = adamw.update(cfg, g, state, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)
    assert float(metrics["lr"]) <= cfg.lr


def test_clipping_bounds_update():
    cfg = adamw.AdamWConfig(lr=1.0, clip_norm=1e-3, warmup_steps=0,
                            total_steps=10)
    params = {"w": torch.zeros(4)}
    state = adamw.init(params)
    new_p, _, m = adamw.update(cfg, {"w": torch.full((4,), 1e6)}, state,
                               params)
    assert float(m["grad_norm"]) > 1e5
    assert float(new_p["w"].abs().max()) < 10.0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,shard,n_shards,batch,seq,vocab", [
    (0, 0, 0, 1, 4, 32, 512), (3, 11, 2, 4, 8, 32, 1000),
    (7, 123456, 1, 2, 6, 17, 49152), (0, 5, 0, 1, 16, 1024, 49152)])
def test_batches_bit_equal_to_reference(seed, step, shard, n_shards, batch,
                                        seq, vocab):
    kw = dict(global_batch=batch, seq_len=seq, vocab_size=vocab, seed=seed)
    want = JaxSyntheticLM(JaxDataConfig(**kw)).batch(step, shard, n_shards)
    got = SyntheticLM(DataConfig(**kw)).batch(step, shard, n_shards)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_bad_shard_count_raises():
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(global_batch=6, seq_len=8,
                               vocab_size=10)).batch(0, shard=0, n_shards=4)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                       "blocks": ({"wq": rng.standard_normal((2, 3, 5))
                                   .astype(np.float32)},),
                       "emb": rng.standard_normal((6, 4)).astype(np.float32)},
            "opt": {"m": rng.standard_normal((8, 4)).astype(np.float32),
                    "step": np.asarray(7, np.int32)}}


def _torch_state(seed):
    """The state of :func:`_arrays` as tensors, ``emb`` in bf16."""
    st = tree_map(torch.from_numpy, _arrays(seed))
    st["params"]["emb"] = st["params"]["emb"].bfloat16()
    return st


def _jax_state(seed):
    st = jax.tree.map(jnp.asarray, _arrays(seed))
    st["params"]["emb"] = st["params"]["emb"].astype(jnp.bfloat16)
    return st


def test_port_checkpoint_restores_in_reference(tmp_path):
    st = _torch_state(0)
    CheckpointManager(str(tmp_path)).save(5, st, {"loss": 1.5})
    mgr = JaxCheckpointManager(str(tmp_path))
    got = mgr.restore(5, _jax_state(1))
    assert mgr.metadata(5) == {"step": 5, "loss": 1.5}
    flat = dict(flatten_with_path(st))
    for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        want = flat[jax.tree_util.keystr(path)]
        assert tuple(leaf.shape) == tuple(want.shape)
        np.testing.assert_array_equal(_jnp_np(leaf), _np(want))
    with np.load(tmp_path / "step_00000005" / "arrays.npz") as z:
        assert sorted(z.files) == sorted(flat)
        assert z["['params']['emb']"].dtype == np.float32
        assert z["['opt']['step']"].dtype == np.int32


def test_reference_checkpoint_restores_in_port(tmp_path):
    st = _jax_state(2)
    JaxCheckpointManager(str(tmp_path)).save(9, st, {"note": "ref"})
    mgr = CheckpointManager(str(tmp_path))
    template = _torch_state(3)
    got = mgr.restore(9, template)
    assert mgr.metadata(9)["note"] == "ref" and mgr.latest_step() == 9
    for (key, t), j in zip(flatten_with_path(got), jax.tree.leaves(st)):
        want = dict(flatten_with_path(template))[key]
        assert t.dtype == want.dtype and t.shape == want.shape, key
        np.testing.assert_array_equal(_np(t), _jnp_np(j), err_msg=key)
    # into a shapes-only template on the meta device, placed on the host
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), template)
    again = mgr.restore(9, meta, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(again), leaves(got)))
    with pytest.raises(ValueError):
        mgr.restore(9, meta)


def test_roundtrip_exact(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    st = _torch_state(0)
    mgr.save(5, st, {"loss": 1.5})
    got = mgr.restore(5, _torch_state(1))
    for a, b in zip(leaves(st), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert mgr.metadata(5)["loss"] == 1.5


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 6):
        mgr.save(s, _torch_state(s))
    assert mgr.all_steps() == [4, 5]
    assert mgr.latest_step() == 5


def test_async_save_and_error_surfacing(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = _torch_state(1)
    mgr.save_async(1, st)
    st["params"]["w"].add_(1.0)           # the snapshot was taken already
    mgr.wait()
    assert mgr.all_steps() == [1]
    got = mgr.restore(1, st)
    assert torch.equal(got["params"]["w"] + 1.0, st["params"]["w"])
    # duplicate step -> FileExistsError surfaced on wait()
    mgr.save_async(1, st)
    with pytest.raises(FileExistsError):
        mgr.wait()
    mgr.wait()                            # raised once, then clear


def test_atomicity_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(3, _torch_state(3))
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    # a crashed write's .tmp directory is not a step
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.latest_step() == 3


def test_shape_mismatch_and_missing_leaf_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, _torch_state(0))
    bad = _torch_state(0)
    bad["params"]["w"] = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        mgr.restore(1, bad)
    extra = _torch_state(0)
    extra["params"]["new"] = torch.zeros(3)
    with pytest.raises(KeyError):
        mgr.restore(1, extra)


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_flags_outlier():
    wd = StragglerWatchdog(factor=3.0, warmup=3)
    flags = [wd.observe(t) for t in [1.0, 1.1, 0.9, 1.0, 10.0, 1.0]]
    assert flags == [False, False, False, False, True, False]
    assert wd.flagged == 1
