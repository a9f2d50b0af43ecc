"""K1's list call, ``log2quant_many``, held against the JAX package.

On the CPU the wrapper runs its plain version into the same flat layout
the CUDA kernel writes: every entry's codes bit-equal to the reference's
Pallas quantizer (interpret mode) and to ``repro.core.log2_quantize``,
the flat buffers the concatenation of the views, the argument checks
those of ``log2quant``, and the launch plan (entries per launch, dtype
groups, offsets) what the kernel is handed.  The kernel itself is held
against this plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import log2_quantize as jax_log2_quantize
from repro.kernels import log2_quantize_pallas
from repro_torch.core.logquant import LogQuantized, log2_quantize
from repro_torch.kernels.log2quant import ops as l2_ops
from repro_torch.models import paper_nets
from repro_torch.simulator import measure
from test_torch_kernels import DTYPES, as_pair, lattice, negative_subnormal

# entry shapes of the ragged list: empty, one element, the vector widths'
# neighbours, an odd 2-D shape, and a long entry
SHAPES = [(0,), (1,), (3,), (15,), (16,), (17,), (1000,), (7, 13), (0, 5)]


def ragged(seed: int, n_lattice: int) -> list:
    """The entries of ``SHAPES`` cut from the lattice (cycled), then the
    whole lattice, as f32 numpy arrays."""
    lat = lattice(seed)
    pool = np.resize(lat, sum(int(np.prod(s)) for s in SHAPES))
    out, o = [], 0
    for s in SHAPES:
        n = int(np.prod(s))
        out.append(pool[o:o + n].reshape(s))
        o += n
    return out + [lat[:n_lattice]]


def _check_entry(t, view, n_bits, e_ref, s_ref):
    """Exponents bit-equal; signs bit-equal except at negative subnormals
    (``test_torch_kernels.test_log2quant_plain_bit_equal_to_reference``:
    XLA on the CPU may read them as zero in ``x < 0``)."""
    daz = negative_subnormal(t.reshape(-1))
    np.testing.assert_array_equal(view.exp.reshape(-1).numpy(),
                                  np.asarray(e_ref).reshape(-1))
    np.testing.assert_array_equal(view.sign.reshape(-1).numpy()[~daz],
                                  np.asarray(s_ref).reshape(-1)[~daz])
    assert (view.sign.reshape(-1).numpy()[daz] == -1).all()


@pytest.mark.parametrize("n_bits", range(2, 9))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_many_plain_bit_equal_to_reference(dtype, n_bits):
    """Entry by entry against the Pallas quantizer; the flat buffer against
    ``repro.core.log2_quantize`` of the concatenation (elementwise, so the
    same comparison entry by entry)."""
    pairs = [as_pair(a, dtype) for a in ragged(n_bits, 837)]
    ts = [t for t, _ in pairs]
    flat, views = l2_ops.log2quant_many(ts, n_bits)
    for t, (_, j), v in zip(ts, pairs, views):
        assert v.exp.shape == v.sign.shape == t.shape
        if t.numel():
            _check_entry(t, v, n_bits,
                         *log2_quantize_pallas(j, n_bits=n_bits,
                                               interpret=True))
    whole = jnp.concatenate([j.reshape(-1) for _, j in pairs])
    qj = jax_log2_quantize(whole, n_bits)
    _check_entry(torch.cat([t.reshape(-1) for t in ts]), flat, n_bits,
                 qj.exp, qj.sign)
    assert flat.exp.dtype == flat.sign.dtype == torch.int8


@pytest.mark.parametrize("n_bits", [2, 4, 8])
def test_many_mixed_dtypes_bit_equal_to_reference(n_bits):
    """A list that interleaves f32, bf16 and f16 entries: each coded as
    its own dtype, in list order."""
    names = sorted(DTYPES)
    pairs = [as_pair(a, names[i % 3])
             for i, a in enumerate(ragged(20 + n_bits, 500))]
    ts = [t for t, _ in pairs]
    flat, views = l2_ops.log2quant_many(ts, n_bits)
    for t, (_, j), v in zip(ts, pairs, views):
        if t.numel():
            qj = jax_log2_quantize(j, n_bits)
            _check_entry(t, v, n_bits, qj.exp, qj.sign)
    assert {t.dtype for t in ts} == {d for d, _ in DTYPES.values()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_many_flat_layout(dtype):
    """The flat buffers are the views back to back with no gaps; each view
    has its input's shape and lies in the flat buffers; the one-entry
    call is ``log2quant``."""
    ts = [torch.from_numpy(a).to(DTYPES[dtype][0]) for a in ragged(3, 837)]
    flat, views = l2_ops.log2quant_many(ts)
    total = sum(t.numel() for t in ts)
    assert flat.exp.shape == flat.sign.shape == (total,)
    for key in ("exp", "sign"):
        whole = getattr(flat, key)
        assert torch.equal(whole, torch.cat(
            [getattr(v, key).reshape(-1) for v in views]))
        o = 0
        for t, v in zip(ts, views):
            part = getattr(v, key)
            assert part.shape == t.shape
            if t.numel():
                assert part.data_ptr() == whole.data_ptr() + o
            o += t.numel()
    for t, v in zip(ts, views):
        q = l2_ops.log2quant(t)
        ref = log2_quantize(t)
        assert torch.equal(q.exp, ref.exp) and torch.equal(q.sign, ref.sign)
        assert torch.equal(v.exp, ref.exp) and torch.equal(v.sign, ref.sign)
    empty, none = l2_ops.log2quant_many([])
    assert none == [] and empty.exp.shape == (0,)


def test_many_rejects_what_log2quant_rejects():
    """The same exceptions and messages as ``log2quant``; a list across
    devices is refused; the CPU runs the plain version and launches
    nothing."""
    before = l2_ops.log2quant.launches
    ok = torch.zeros(4)
    for call in (l2_ops.log2quant, lambda x, **kw: l2_ops.log2quant_many(
            [ok, x], **kw)):
        with pytest.raises(TypeError, match="f32/bf16/f16"):
            call(torch.zeros(4, dtype=torch.float64))
        with pytest.raises(ValueError, match="outside 2..8"):
            call(torch.zeros(4), n_bits=9)
        with pytest.raises(ValueError, match="outside 2..8"):
            call(torch.zeros(4), n_bits=1)
    with pytest.raises(ValueError, match="runs on CUDA or CPU"):
        l2_ops.log2quant(torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="one device"):
        l2_ops.log2quant_many([ok, torch.zeros(4, device="meta")])
    l2_ops.log2quant_many([ok, torch.zeros(3).bfloat16()])
    assert l2_ops.log2quant.launches == before


@pytest.mark.parametrize("n", [1, 96, 128, 129, 210, 256, 257])
def test_launch_plan_takes_max_entries_a_launch(n):
    """Launches of ``MAX_ENTRIES`` (at least the 96 BERT-large records)
    entries each, in list order, offsets the flat layout's."""
    assert l2_ops.MAX_ENTRIES >= 96
    sizes = [(i * 37) % 50 + 1 for i in range(n)]
    plan = l2_ops.launch_plan([torch.zeros(s) for s in sizes])
    assert len(plan) == -(-n // l2_ops.MAX_ENTRIES)
    assert all(len(p) <= l2_ops.MAX_ENTRIES for p in plan)
    flat = [e for p in plan for e in p]
    assert [i for i, _ in flat] == list(range(n))
    assert [o for _, o in flat] == list(np.cumsum([0] + sizes[:-1]))


def test_launch_plan_groups_dtypes_and_drops_empty_entries():
    xs = [torch.zeros(5), torch.zeros(3).bfloat16(), torch.zeros(0),
          torch.zeros(2).half(), torch.zeros(4), torch.zeros(0).bfloat16(),
          torch.zeros(6).bfloat16()]
    plan = l2_ops.launch_plan(xs)
    assert plan == [[(0, 0), (4, 10)], [(1, 5), (6, 14)], [(3, 8)]]
    assert {xs[i].dtype for p in plan for i, _ in p[:1]} == {
        torch.float32, torch.bfloat16, torch.float16}
    assert l2_ops.launch_plan([torch.zeros(0)] * 3) == []


@pytest.mark.parametrize("net", ["odd-sizes", "ptblm", "encoder"])
def test_paper_net_measure_of_flat_equals_concatenation(net):
    """The paper path's coding on the CPU: the views equal the per-tensor
    codes, and ``measure`` of the flat buffer is exactly ``measure`` of
    ``torch.cat`` of the per-tensor codes."""
    gen = torch.Generator().manual_seed(5)
    if net == "ptblm":
        acts = paper_nets.ptblm_activations(paper_nets.init_paper_params(
            "ptblm", gen, "cpu", seq=4, hidden=16))
    elif net == "encoder":
        acts = paper_nets._encoder_activations(
            paper_nets._encoder_params(gen, "cpu", 2, 64, 128, 8), "gelu")
    else:
        acts = [(f"x{i}", torch.randn((3, 5 + 2 * i), generator=gen))
                for i in range(8)]
    xs = [a for _, a in acts]
    flat, views = l2_ops.log2quant_many(xs)
    codes = [l2_ops.log2quant(a) for a in xs]
    for v, q in zip(views, codes):
        assert torch.equal(v.exp, q.exp) and torch.equal(v.sign, q.sign)
    exp = torch.cat([q.exp.reshape(-1) for q in codes])
    a = measure(LogQuantized(flat.exp, torch.ones_like(flat.exp)))
    b = measure(LogQuantized(exp, torch.ones_like(exp)))
    assert np.array_equal(a.hist, b.hist) and a.zero_frac == b.zero_frac
