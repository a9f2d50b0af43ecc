"""The port's paged-attention decode (K3) held against the JAX package's:
the plain PyTorch version of the kernel body
(``repro_torch.kernels.paged_attention.ops.paged_attention_plain``, what
the wrapper runs on CPU tensors and what the CUDA kernel is held against
on the card) against the Pallas kernel in interpret mode, as the
reference's own tests run it.

Tolerances are the reference's (``tests/test_paged_attention.py``): f32
``rtol=2e-5, atol=2e-6`` — both sides reassociate the same f32 sums in a
different order; bf16 ``atol=2e-2`` — both round ``p`` to bf16 before PV,
so nearly equal ``p`` may round apart.  Partials are compared on the
splits that hold a valid token: a split with none is junk by design (the
reference accumulates ``exp(0)`` junk there, the port skips the split's
pages and keeps ``m = NEG_INF``, ``l = 0``), and the merge weighs it by
exactly 0.0 either way, so merged outputs are compared on every row with
a valid token.  Trash-page poison, aliased tables and all-masked splits
are bitwise checks, as in the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import kernel as jax_kernel
from repro.kernels.paged_attention import ops as jax_ops
from repro.kernels.paged_attention.ref import \
    paged_attention_reference as jax_oracle
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_reference

F32_TOL = dict(rtol=2e-5, atol=2e-6)
BF16_TOL = dict(rtol=0.0, atol=2e-2)
TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _lengths_lattice(page_len, nb):
    mx = page_len * nb
    cand = [0, 1, page_len - 1, page_len, page_len + 1, 2 * page_len, mx]
    return [ln for ln in dict.fromkeys(cand) if 0 <= ln <= mx]


def _case(rng, *, page_len, nb, g, r, d, lengths, poison=0.0):
    """Numpy pool + table laid out as the scheduler lays them out: each
    row's first ceil(len / page_len) entries name fresh pages, the rest
    the trash page, which holds ``poison``."""
    b = len(lengths)
    n_pages = 1 + b * nb
    k = rng.standard_normal((n_pages, page_len, g, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, page_len, g, d)).astype(np.float32)
    k[0] = poison
    v[0] = poison
    table = ops.make_page_table(lengths, nb, page_len)
    q = rng.standard_normal((b, 1, g * r, d)).astype(np.float32)
    return q, k, v, table, np.asarray(lengths, np.int32)


def _torch(arrs, dtype=torch.float32):
    q, k, v, table, lens = arrs
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
            torch.from_numpy(v).to(dtype), torch.from_numpy(table),
            torch.from_numpy(lens))


def _jax(arrs, dtype=jnp.float32):
    q, k, v, table, lens = arrs
    return (jnp.asarray(q, dtype), jnp.asarray(k, dtype),
            jnp.asarray(v, dtype), jnp.asarray(table), jnp.asarray(lens))


def _f32(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


def _check(arrs, splits, dtype=jnp.float32, tol=F32_TOL):
    q, k, v, table, lens = _torch(arrs, TORCH_DT[dtype])
    jq, jk, jv, jt, jl = _jax(arrs, dtype)
    b, _, h, d = q.shape
    g = k.shape[2]
    nb = table.shape[1]
    pad = (-nb) % splits
    ptable = torch.nn.functional.pad(table, (0, pad))
    o, m, l = ops.paged_attention(q.reshape(b, g, h // g, d), k, v, ptable,
                                  lens, splits)
    jo, jm, jlv = jax_kernel.paged_attention_kernel(
        jq.reshape(b, g, h // g, d), jk, jv, jnp.pad(jt, ((0, 0), (0, pad))),
        jl, splits=splits, interpret=True)
    jm = np.asarray(jm)
    real = jm > ops.NEG_INF / 2               # splits with a valid token
    np.testing.assert_array_equal(m.numpy() > ops.NEG_INF / 2, real)
    np.testing.assert_allclose(m.numpy()[real], jm[real], **tol)
    np.testing.assert_allclose(l.numpy()[real], np.asarray(jlv)[real], **tol)
    np.testing.assert_allclose(o.numpy()[real], np.asarray(jo)[real], **tol)
    out = ops.paged_decode_attention(q, k, v, table, lens, splits=splits)
    # the reference wrapper's merge of the Pallas partials
    jout = jax_ops.merge_split_softmax(jnp.asarray(jm), jlv, jo, axis=2)
    jout = np.asarray(jout).reshape(b, 1, h, d).astype(np.float32)
    if dtype == jnp.bfloat16:
        jout = np.asarray(jnp.asarray(jout, jnp.bfloat16), np.float32)
    live = arrs[4] > 0
    np.testing.assert_allclose(_f32(out)[live], _f32(jout)[live], **tol)
    np.testing.assert_allclose(
        _f32(out)[live],
        _f32(paged_attention_reference(q, k, v, table, lens))[live], **tol)
    assert np.isfinite(_f32(out)).all()
    assert out.dtype == q.dtype and out.shape == q.shape


# every page_len and every head dim, both dims at page_len 8 (the full
# cross product costs twice the Pallas-interpret time for no new path)
@pytest.mark.parametrize("page_len,nb,d", [(1, 4, 8), (4, 4, 16), (8, 3, 8),
                                           (8, 3, 16)])
@pytest.mark.parametrize("g,r", [(1, 1), (2, 2), (1, 3)])
def test_f32_lattice_matches_pallas(page_len, nb, d, g, r):
    rng = np.random.default_rng(page_len * 100 + g * 10 + r + d)
    arrs = _case(rng, page_len=page_len, nb=nb, g=g, r=r, d=d,
                 lengths=_lengths_lattice(page_len, nb), poison=1e4)
    for splits in (1, 2, 3, 4):
        _check(arrs, splits)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_bf16_matches_pallas(splits):
    rng = np.random.default_rng(42 + splits)
    arrs = _case(rng, page_len=4, nb=4, g=2, r=2, d=16,
                 lengths=_lengths_lattice(4, 4), poison=1e4)
    _check(arrs, splits, jnp.bfloat16, BF16_TOL)


def test_full_width_head_geometry_matches_pallas():
    """smollm-135m's decode geometry: G = 3 kv heads of R = 3 queries,
    D = 64, page_len 16."""
    rng = np.random.default_rng(5)
    arrs = _case(rng, page_len=16, nb=4, g=3, r=3, d=64,
                 lengths=[1, 17, 40, 64], poison=-1e4)
    for splits in (1, 2):
        _check(arrs, splits)


def test_oracle_matches_reference_oracle():
    rng = np.random.default_rng(6)
    arrs = _case(rng, page_len=4, nb=4, g=2, r=2, d=8,
                 lengths=_lengths_lattice(4, 4))
    live = arrs[4] > 0
    np.testing.assert_allclose(
        _f32(paged_attention_reference(*_torch(arrs)))[live],
        _f32(jax_oracle(*_jax(arrs)))[live], **F32_TOL)


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_poison_invisible_bitwise(splits):
    """Rows with a valid token are bitwise independent of the trash
    page's contents; length-0 rows are only finite."""
    lengths = [0, 1, 3, 4, 5, 16]
    live = np.asarray(lengths) > 0
    outs = []
    for poison in (0.0, 1e4, -1e4):
        arrs = _case(np.random.default_rng(11), page_len=4, nb=4, g=2, r=2,
                     d=8, lengths=lengths, poison=poison)
        out = ops.paged_decode_attention(*_torch(arrs), splits=splits)
        assert np.isfinite(out.numpy()).all()
        outs.append(out.numpy())
    for out in outs[1:]:
        np.testing.assert_array_equal(out[live], outs[0][live])


def test_aliased_tables_read_like_a_deep_copy():
    rng = np.random.default_rng(12)
    q, k, v, table, lens = _case(rng, page_len=4, nb=4, g=2, r=2, d=8,
                                 lengths=[8, 9, 12])
    table = table.copy()
    table[1, :2] = table[0, :2]                 # shared 8-token prefix
    table[2, :2] = table[0, :2]
    aliased = ops.paged_decode_attention(
        *_torch((q, k, v, table, lens)), splits=2)
    k2 = np.concatenate([k, k[table[0, :2]], k[table[0, :2]]])
    v2 = np.concatenate([v, v[table[0, :2]], v[table[0, :2]]])
    fresh = np.arange(len(k2) - 4, len(k2))
    t2 = table.copy()
    t2[1, :2] = fresh[:2]
    t2[2, :2] = fresh[2:]
    deep = ops.paged_decode_attention(*_torch((q, k2, v2, t2, lens)),
                                      splits=2)
    np.testing.assert_array_equal(aliased.numpy(), deep.numpy())


def test_splits_bitwise_when_valid_pages_sit_in_split_zero():
    rng = np.random.default_rng(24)
    arrs = _torch(_case(rng, page_len=4, nb=4, g=2, r=2, d=8,
                        lengths=[4, 7, 8]))
    base = ops.paged_decode_attention(*arrs, splits=1).numpy()
    np.testing.assert_array_equal(
        ops.paged_decode_attention(*arrs, splits=2).numpy(), base)
    out4 = ops.paged_decode_attention(*arrs, splits=4).numpy()
    np.testing.assert_allclose(out4, base, **F32_TOL)
    np.testing.assert_array_equal(out4[0], base[0])


def _partials(s, v, bounds):
    ms, ls, accs = [], [], []
    for lo, hi in bounds:
        blk = s[:, lo:hi]
        m = (np.max(blk, axis=1) if hi > lo
             else np.full(s.shape[0], ops.NEG_INF))
        p = np.exp(blk - m[:, None])
        ms.append(m)
        ls.append(p.sum(axis=1))
        accs.append(p @ v[lo:hi])
    return (np.stack(ms, 1).astype(np.float32),
            np.stack(ls, 1).astype(np.float32),
            np.stack(accs, 1).astype(np.float32))


def _merge_both(m, l, acc, axis=1):
    ours = ops.merge_split_softmax(torch.from_numpy(m), torch.from_numpy(l),
                                   torch.from_numpy(acc), axis=axis).numpy()
    theirs = np.asarray(jax_ops.merge_split_softmax(
        jnp.asarray(m), jnp.asarray(l), jnp.asarray(acc), axis=axis))
    return ours, theirs


def test_merge_extreme_logits_match_reference_and_monolithic():
    rng = np.random.default_rng(21)
    s = rng.choice([-1e4, -30.0, -1.0, 0.5, 30.0, 1e4],
                   size=(4, 24)).astype(np.float32)
    v = rng.standard_normal((24, 8)).astype(np.float32)
    ours, theirs = _merge_both(*_partials(s, v, [(0, 7), (7, 16), (16, 24)]))
    e = np.exp(s - s.max(1, keepdims=True))
    mono = (e / e.sum(1, keepdims=True)) @ v
    np.testing.assert_allclose(ours, mono, rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(ours, theirs, rtol=2e-5, atol=1e-7)


def test_merge_all_masked_split_is_bitwise_absent():
    rng = np.random.default_rng(22)
    s = rng.standard_normal((3, 12)).astype(np.float32) * 5
    v = rng.standard_normal((12, 4)).astype(np.float32)
    m, l, acc = _partials(s, v, [(0, 6), (6, 12)])
    with_junk = ops.merge_split_softmax(
        torch.from_numpy(np.concatenate(
            [m, np.full((3, 1), ops.NEG_INF, np.float32)], 1)),
        torch.from_numpy(np.concatenate(
            [l, np.full((3, 1), 123.456, np.float32)], 1)),
        torch.from_numpy(np.concatenate(
            [acc, np.full((3, 1, 4), -777.0, np.float32)], 1)), axis=1)
    without = ops.merge_split_softmax(torch.from_numpy(m),
                                      torch.from_numpy(l),
                                      torch.from_numpy(acc), axis=1)
    np.testing.assert_array_equal(with_junk.numpy(), without.numpy())


def test_merge_all_splits_masked_is_finite():
    m = np.full((2, 3), ops.NEG_INF, np.float32)
    for l in (np.full((2, 3), 4.0, np.float32),
              np.zeros((2, 3), np.float32)):        # the kernel's skip
        ours, _ = _merge_both(m, l, np.ones((2, 3, 5), np.float32))
        assert np.isfinite(ours).all()


def test_merge_single_valid_token_is_exact():
    vrow = np.random.default_rng(23).standard_normal((1, 6)).astype(
        np.float32)
    for logit in (-1e4, 0.0, 1e4):
        m = np.asarray([[ops.NEG_INF, logit, ops.NEG_INF]], np.float32)
        l = np.asarray([[7.0, 1.0, 7.0]], np.float32)
        acc = np.stack([np.full((1, 6), 9.0, np.float32), vrow,
                        np.full((1, 6), -9.0, np.float32)], 1)
        ours, theirs = _merge_both(m, l, acc)
        np.testing.assert_array_equal(ours, vrow)
        np.testing.assert_array_equal(theirs, vrow)


def test_ragged512_traffic_and_page_table_match_reference():
    geo = ops.RAGGED512
    assert geo == jax_kernel.RAGGED512
    table = ops.make_page_table(geo["lengths"], geo["nb"], geo["page_len"])
    np.testing.assert_array_equal(table, jax_kernel.make_page_table(
        geo["lengths"], geo["nb"], geo["page_len"]))
    counts = ops.gather_traffic_counts(table, np.asarray(geo["lengths"]),
                                       geo["page_len"])
    assert counts == (57.0, 128.0)
    assert counts == jax_ops.gather_traffic_counts(
        table, np.asarray(geo["lengths"]), geo["page_len"])


def test_wrapper_refuses_bad_operands():
    arrs = _torch(_case(np.random.default_rng(0), page_len=4, nb=4, g=1,
                        r=1, d=8, lengths=[3, 5]))
    q, k, v, table, lens = arrs
    qg = q.reshape(2, 1, 1, 8)
    with pytest.raises(ValueError, match="multiple of splits"):
        ops.paged_attention(qg, k, v, table, lens, 3)
    with pytest.raises(TypeError, match="int32"):
        ops.paged_attention(qg, k, v, table.long(), lens, 1)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.paged_attention(qg.to("meta"), k.to("meta"), v.to("meta"),
                            table.to("meta"), lens.to("meta"), 1)
    before = ops.paged_attention.launches
    ops.paged_attention(qg, k, v, table, lens, 2)   # plain version on CPU
    assert ops.paged_attention.launches == before
