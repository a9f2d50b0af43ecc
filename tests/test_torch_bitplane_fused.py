"""The port's fused LOG2-quantize + bit-plane GEMM
(``kernels.bitplane_matmul.ops.log2_bitplane_matmul``) held against the
JAX package's composition of the same function:
``repro.core.logquant.log2_quantize`` of ``x / act_scale``, then
``repro.core.bitplane.unpack_planes`` for packed planes, then
``repro.core.shiftadd.shiftadd_matmul_bitplane``.

On the CPU the op runs its plain version; the int32 output and the codes
it returns must be bit-equal to the reference's.  The CUDA kernel is held
against this plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jax_bp
from repro.core import logquant as jax_lq
from repro.core import shiftadd as jax_sa
from repro_torch.core import bitplane, shiftadd
from repro_torch.core.logquant import LogQuantized
from repro_torch.kernels.bitplane_matmul import ops as bm_ops

# the four main-path (K, N) at small N, and a K that is not a multiple of
# 128 (but of 8, so the packed layout exists)
KN = [(576, 24), (576, 8), (576, 64), (1536, 24), (200, 16)]


def _inputs(m, k, n, seed):
    """Activations over ~16 octaves with exact zeros and a cold corner,
    and random int8 weights as (unpacked, packed) reference planes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)) * 2.0 ** rng.integers(-6, 4, (m, k))
    x[rng.random((m, k)) < 0.1] = 0.0
    x[: m // 2 + 1, : k // 3] *= 1e-4
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    planes = jax_bp.to_bitplanes(jnp.asarray(w))
    return (x.astype(np.float32), np.asarray(planes),
            np.asarray(jax_bp.pack_planes(planes, axis=0)))


def _reference(x_f32, act_scale, planes, n_bits):
    xs = jnp.asarray(x_f32) / jnp.float32(act_scale)
    q = jax_lq.log2_quantize(xs, n_bits)
    p = jnp.asarray(planes)
    if p.shape[1] * 8 == x_f32.shape[1]:
        p = jax_bp.unpack_planes(p, axis=0)
    y = jax_sa.shiftadd_matmul_bitplane(q, p, n_bits)
    return np.asarray(y), np.asarray(q.exp), np.asarray(q.sign)


MS = [1, 4, 17, 128]
DTYPES = (torch.float32, torch.bfloat16)
ACTS = (1.0, 0.37)
N_BITS = (2, 4, 5)


@functools.lru_cache(maxsize=None)
def _stacked_case(k, n):
    """The rows of every M in ``MS`` stacked, and the reference's results
    on them for every (layout, dtype, act_scale, n_bits): its rows are
    independent of each other, so one reference run per (K, N) serves
    every M (and JAX compiles its ops for 5 shapes, not 20)."""
    x, unpacked, packed = _inputs(sum(MS), k, n, k + n)
    refs = {}
    for layout, planes in (("unpacked", unpacked), ("packed", packed)):
        for dtype in DTYPES:
            xw = torch.from_numpy(x).to(dtype).float().numpy()
            for act in ACTS:
                for n_bits in N_BITS:
                    refs[(layout, dtype, act, n_bits)] = _reference(
                        xw, act, planes, n_bits)
    return x, {"unpacked": unpacked, "packed": packed}, refs


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k,n", KN)
@pytest.mark.parametrize("m", MS)
def test_fused_plain_bit_equal_to_reference(m, k, n, packed):
    """x in f32 and bf16, act_scale 1.0 and 0.37, n_bits 2, 4 and 5: the
    int32 output and the codes equal the reference's bit for bit."""
    x, layouts, refs = _stacked_case(k, n)
    layout = "packed" if packed else "unpacked"
    rows = slice(sum(MS[:MS.index(m)]), sum(MS[:MS.index(m) + 1]))
    tp = torch.from_numpy(layouts[layout])
    assert bm_ops.is_packed(tp, k) == packed
    before = bm_ops.bitplane_matmul.launches
    for dtype in DTYPES:
        xt = torch.from_numpy(x[rows]).to(dtype)
        for act in ACTS:
            a = torch.tensor(act, dtype=torch.float32)
            for n_bits in N_BITS:
                y, q = bm_ops.log2_bitplane_matmul(xt, a, tp, n_bits,
                                                   codes=True)
                want, exp, sign = refs[(layout, dtype, act, n_bits)]
                assert y.dtype == torch.int32 and y.shape == (m, n)
                np.testing.assert_array_equal(y.numpy(), want[rows])
                np.testing.assert_array_equal(q.exp.numpy(), exp[rows])
                np.testing.assert_array_equal(q.sign.numpy(), sign[rows])
    assert bm_ops.bitplane_matmul.launches == before


def _special_activations(m, k, seed):
    """IEEE specials, the sqrt(2) comparator's edge mantissas, subnormals
    and random magnitudes, laid out as (m, k)."""
    fields = np.arange(110, 146, dtype=np.uint32)
    edges = np.concatenate([((fields << 23) | mm).view(np.float32)
                            for mm in (3474675, 3474676)])
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-38, -1e-38,
                        2.0 ** -8, 2.0 ** 7, 1.5, -1.5], np.float32)
    sub = np.array([1, 0x7FFFFF], np.uint32).view(np.float32)
    rng = np.random.default_rng(seed)
    vals = np.concatenate([special, edges, -edges, sub, -sub])
    rand = rng.normal(0, 1, m * k - vals.size) * 2.0 ** rng.integers(
        -12, 12, m * k - vals.size)
    return np.concatenate([vals, rand.astype(np.float32)]).reshape(m, k)


def _negative_subnormal(t: torch.Tensor) -> np.ndarray:
    bits = t.float().view(torch.int32).numpy().view(np.uint32)
    return (bits >> 31 == 1) & ((bits >> 23) & 0xFF == 0) & (
        bits & 0x7FFFFF != 0)


@pytest.mark.parametrize("act", [1.0, 0.37, 2.0 ** -3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_codes_on_special_values(dtype, act):
    """The codes the op returns are the reference quantizer's on x /
    act_scale, specials included, and the output follows them.  Signs are
    compared everywhere but where x or x / act_scale is a negative
    subnormal: there the port follows the specification (-1), while XLA on
    the CPU may read subnormals as zero and give +1; both codes are the
    sentinel, which contributes nothing (as in
    ``test_torch_kernels.test_log2quant_plain_bit_equal_to_reference``)."""
    m, k, n = 6, 40, 8
    x = _special_activations(m, k, 3)
    _, planes, _ = _inputs(m, k, n, 4)
    xt = torch.from_numpy(x).to(dtype)
    a = torch.tensor(act, dtype=torch.float32)
    daz = _negative_subnormal(xt) | _negative_subnormal(xt.float() / a)
    for n_bits in (2, 3, 4, 5):
        y, q = bm_ops.log2_bitplane_matmul(xt, a, torch.from_numpy(planes),
                                           n_bits, codes=True)
        want, exp, sign = _reference(xt.float().numpy(), act, planes,
                                     n_bits)
        sentinel = -(1 << (n_bits - 1))
        np.testing.assert_array_equal(q.exp.numpy(), exp)
        np.testing.assert_array_equal(q.sign.numpy()[~daz], sign[~daz])
        assert (q.exp.numpy()[daz] == sentinel).all()
        np.testing.assert_array_equal(y.numpy(), want)
        assert bool((q.exp.numpy() == sentinel).any())


@pytest.mark.parametrize("m, n, n_bits, want", [
    (4, 1536, 4, False), (64, 1536, 4, False), (127, 576, 4, False),
    (128, 192, 4, False), (128, 384, 4, True), (128, 576, 4, True),
    (256, 192, 4, True), (256, 576, 5, False)])
def test_wrapper_body_switch(m, n, n_bits, want):
    """The wrapper takes the tensor cores from 128 rows and 128 x 384
    outputs, up to 4 bits: decode rows, 64-row buckets and the N = 192
    projections at 128 rows stay on the integer body."""
    assert bm_ops.tensor_core_body(m, n, n_bits) is want


@pytest.mark.parametrize("packed", [False, True])
def test_codes_entry_takes_both_layouts(packed):
    """``bitplane_matmul`` (codes in) on packed planes equals it on the
    unpacked ones and the reference's GEMM of the same codes."""
    m, k, n = 9, 200, 16
    x, unpacked, packed_planes = _inputs(m, k, n, 5)
    q = jax_lq.log2_quantize(jnp.asarray(x))
    want = np.asarray(jax_sa.shiftadd_matmul_bitplane(q, jnp.asarray(
        unpacked)))
    planes = torch.from_numpy(packed_planes if packed else unpacked)
    y = bm_ops.bitplane_matmul(torch.from_numpy(np.asarray(q.exp)),
                               torch.from_numpy(np.asarray(q.sign)), planes)
    np.testing.assert_array_equal(y.numpy(), want)


def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((4, 16))
    a = torch.tensor(1.0)
    planes = torch.zeros((8, 16, 8), dtype=torch.uint8)
    packed = torch.zeros((8, 2, 8), dtype=torch.uint8)
    op = bm_ops.log2_bitplane_matmul
    before = bm_ops.bitplane_matmul.launches
    for bad_x in (x.half(), x.double(), x.int()):
        with pytest.raises(TypeError):
            op(bad_x, a, planes)
    with pytest.raises(ValueError):
        op(x[None], a, planes)                       # not (M, K)
    for bad_a in (1.0, a.double(), torch.ones(2)):
        with pytest.raises(TypeError):
            op(x, bad_a, planes)
    with pytest.raises(TypeError):
        op(x, a, planes.to(torch.int8))              # planes not uint8
    for bad_planes in (planes[:, :8], planes[:7], packed[:, :1],
                       planes[0], torch.zeros((8, 3, 8), dtype=torch.uint8)):
        with pytest.raises(ValueError):
            op(x, a, bad_planes)
    with pytest.raises(ValueError):                  # K = 12: no packed form
        op(torch.zeros((4, 12)), a, torch.zeros((8, 1, 8), dtype=torch.uint8))
    for n_bits in (1, 6, 8):
        with pytest.raises(ValueError):
            op(x, a, planes, n_bits=n_bits)
    with pytest.raises(ValueError):                  # tensor cores, 5 bits
        op(x, a, planes, n_bits=5, tensor_cores=True)
    for bad_out in (torch.empty((4, 7), dtype=torch.int32),
                    torch.empty((4, 8), dtype=torch.int64),
                    torch.empty((8, 4), dtype=torch.int32).t()):
        with pytest.raises(ValueError):
            op(x, a, planes, out=bad_out)
    assert op(x, a, planes).shape == (4, 8)
    assert op(x, a, packed).shape == (4, 8)
    y, q = op(x, a, packed, codes=True)
    assert q.exp.shape == q.sign.shape == (4, 16) and not y.any()
    assert bm_ops.bitplane_matmul.launches == before


@pytest.mark.parametrize("lead", [(7,), (3, 5)])
def test_quantized_linear_apply_packed_bit_equal(lead):
    """The projection on packed planes, K not a multiple of 128: the int32
    GEMM output and codes it captures equal the reference's, and its float
    output the reference's within rtol 1e-6 (as
    ``test_torch_core.test_quantized_linear_apply_bit_equal``)."""
    k, n = 200, 24
    rng = np.random.default_rng(21)
    w = (rng.normal(0, 0.05, (k, n))).astype(np.float32)
    x = (rng.normal(0, 1.0, lead + (k,)) * 0.8).astype(np.float32)
    act_scale = 0.37
    p = shiftadd.quantized_linear_init(torch.from_numpy(w),
                                       act_scale=act_scale)
    pj = jax_sa.quantized_linear_init(jnp.asarray(w), act_scale=act_scale)
    p = p._replace(planes=bitplane.pack_planes(p.planes, axis=0))
    pj = pj._replace(planes=jax_bp.pack_planes(pj.planes, axis=0))
    ctx = shiftadd.QuantCtx(capture=[])
    y = shiftadd.quantized_linear_apply(p, torch.from_numpy(x), ctx=ctx)
    yj = jax_sa.quantized_linear_apply(pj, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-6, atol=0)
    _, exp, sign, planes, y_int = ctx.capture[0]
    xs = jnp.asarray(x).reshape(-1, k) / pj.act_scale
    qj = jax_lq.log2_quantize(xs)
    np.testing.assert_array_equal(exp.numpy(), np.asarray(qj.exp))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(qj.sign))
    want = jax_sa.shiftadd_matmul_bitplane(
        qj, jax_bp.unpack_planes(pj.planes, axis=0))
    np.testing.assert_array_equal(y_int.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        shiftadd.shiftadd_matmul_bitplane(LogQuantized(exp, sign),
                                          planes).numpy(), np.asarray(want))
