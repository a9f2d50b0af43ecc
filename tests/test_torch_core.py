"""The port's core (``repro_torch.core``) held against the JAX package's
(``repro.core``) on the same numpy inputs: weight quantization, bit-planes,
packing, ``needed_bits``, dequantization and the quantized projection are
bit-equal (the projection's int32 GEMM output and its float output); so
are the naive quantizer (but for named points within 1 ulp of a LOG2
boundary), the Fig. 2 shares, the access report's counts and the
shift-add oracles; the exact shift-add product and the activation
calibration agree within float32 tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import access_model as jax_access
from repro.core import bitplane as jax_bp
from repro.core import logquant as jax_lq
from repro.core import shiftadd as jax_sa
from repro.core import wquant as jax_wq
from repro_torch.core import access_model, bitplane, logquant, shiftadd, wquant
from test_torch_kernels import lattice, negative_subnormal, subnormal


def _weights(k, n, seed, dtype=np.float32, scale=0.1):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, scale, (k, n)).astype(np.float32)
    w[0, :] = 0.0                                   # an all-zero row
    w[:, 0] = 0.0                                   # an all-zero channel
    return w


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("channel_axis", [-1, None, 0])
def test_quantize_weights_bit_equal(dtype, channel_axis):
    w = _weights(96, 40, 1)
    t = torch.from_numpy(w)
    j = jnp.asarray(w)
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
        j = jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    q = wquant.quantize_weights(t, channel_axis=channel_axis)
    qj = jax_wq.quantize_weights(j, channel_axis=channel_axis)
    np.testing.assert_array_equal(q.q.numpy(), np.asarray(qj.q))
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(qj.scale))
    assert q.q.dtype == torch.int8 and q.scale.dtype == torch.float32


def test_bitplanes_and_packing_bit_equal():
    qj = jnp.asarray(np.arange(-127, 128, dtype=np.int8).reshape(15, 17))
    qt = torch.from_numpy(np.asarray(qj).copy())
    planes = bitplane.to_bitplanes(qt)
    planes_j = jax_bp.to_bitplanes(qj)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(planes_j))
    assert planes.dtype == torch.uint8 and planes.shape == (8, 15, 17)
    np.testing.assert_array_equal(bitplane.from_bitplanes(planes).numpy(),
                                  np.asarray(jax_bp.from_bitplanes(planes_j)))
    assert torch.equal(bitplane.from_bitplanes(planes), qt.int())
    np.testing.assert_array_equal(bitplane.plane_coefficients().numpy(),
                                  np.asarray(jax_bp.plane_coefficients()))
    # pack along K of (8, K, N) planes, the deploy format, and along N
    rng = np.random.default_rng(3)
    p = rng.integers(0, 2, (8, 64, 24)).astype(np.uint8)
    for axis in (0, 1, -1):
        packed = bitplane.pack_planes(torch.from_numpy(p), axis=axis)
        packed_j = jax_bp.pack_planes(jnp.asarray(p), axis=axis)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_j))
        np.testing.assert_array_equal(
            bitplane.unpack_planes(packed, axis=axis).numpy(), p)
    with pytest.raises(ValueError):
        bitplane.pack_planes(torch.from_numpy(p[:, :60]), axis=0)


def test_needed_bits_and_dequantize_bit_equal():
    for n_bits in (2, 4, 5, 8):
        lo, hi = -(1 << (n_bits - 1)), (1 << (n_bits - 1))
        e = np.arange(lo, hi, dtype=np.int8)
        s = np.where(np.arange(e.size) % 3 == 0, -1, 1).astype(np.int8)
        nb = access_model.needed_bits(torch.from_numpy(e), n_bits)
        np.testing.assert_array_equal(
            nb.numpy(), np.asarray(jax_access.needed_bits(jnp.asarray(e),
                                                          n_bits)))
        q = logquant.LogQuantized(torch.from_numpy(e), torch.from_numpy(s))
        qj = jax_lq.LogQuantized(jnp.asarray(e), jnp.asarray(s))
        # the port decodes to exact powers of two.  XLA's exp2 on the CPU
        # is off by up to ~4e-6 relative at integer arguments (hence rtol
        # 1e-5), lands below 2^-126 near the bottom of the range and
        # flushes subnormal results to zero: compared down to 2^-120
        deq = logquant.log2_dequantize(q, n_bits).numpy()
        exact = np.where(e == lo, 0.0, s * np.ldexp(1.0, e.astype(int)))
        np.testing.assert_array_equal(deq, exact.astype(np.float32))
        normal = (exact == 0) | (np.abs(exact) >= 2.0 ** -120)
        np.testing.assert_allclose(
            deq[normal],
            np.asarray(jax_lq.log2_dequantize(qj, n_bits))[normal],
            rtol=1e-5)
        assert logquant.zero_sentinel(n_bits) == jax_lq.zero_sentinel(n_bits)


@pytest.mark.parametrize("act_scale", [1.0, 0.37])
def test_quantized_linear_init_bit_equal(act_scale):
    w = _weights(64, 48, 7)
    p = shiftadd.quantized_linear_init(torch.from_numpy(w),
                                       act_scale=act_scale)
    pj = jax_sa.quantized_linear_init(jnp.asarray(w), act_scale=act_scale)
    for f in ("planes", "w_scale", "act_scale"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(pj, f)))
    assert p.planes.shape == (8, 64, 48) and p.w_scale.shape == (1, 48)
    assert p.bias is None and pj.bias is None


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_quantized_linear_apply_bit_equal(lead, pack):
    """Same weights, same activation: the codes, the int32 GEMM output
    and the traffic counts equal the reference's bit for bit; the float
    output, whose epilogue repeats the reference's operation order, within
    rtol 1e-6 (one ulp of slack for XLA's float fusion)."""
    k, n = 72, 40
    w = _weights(k, n, 11)
    rng = np.random.default_rng(12)
    x = (rng.normal(0, 1.0, lead + (k,)) * 0.8).astype(np.float32)
    x[..., :10] *= 1e-3                             # cold activations
    act_scale = 0.5
    p = shiftadd.quantized_linear_init(torch.from_numpy(w),
                                       act_scale=act_scale)
    pj = jax_sa.quantized_linear_init(jnp.asarray(w), act_scale=act_scale)
    if pack:
        p = p._replace(planes=bitplane.pack_planes(p.planes, axis=0))
        pj = pj._replace(planes=jax_bp.pack_planes(pj.planes, axis=0))
    ctx = shiftadd.QuantCtx(collect=[], capture=[])
    y = shiftadd.quantized_linear_apply(p, torch.from_numpy(x), ctx=ctx)
    coll_j = []
    yj = jax_sa.quantized_linear_apply(pj, jnp.asarray(x), collect=coll_j)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=0)
    assert y.shape == lead + (n,)
    # the GEMM's int32 output, fed the reference's own codes
    xs_t, exp, sign, planes, y_int = ctx.capture[0]
    xs = jnp.asarray(x).reshape(-1, k) / pj.act_scale
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs))
    qj = jax_lq.log2_quantize(xs)
    np.testing.assert_array_equal(exp.numpy(), np.asarray(qj.exp))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(qj.sign))
    planes_j = jax_sa.quantized_linear_init(jnp.asarray(w)).planes
    np.testing.assert_array_equal(planes.numpy(), np.asarray(planes_j))
    np.testing.assert_array_equal(
        y_int.numpy(), np.asarray(jax_sa.shiftadd_matmul_bitplane(qj,
                                                                  planes_j)))
    for got, want in zip(ctx.collect[0], coll_j[0]):
        assert float(got) == float(want)


def test_as_quant_ctx():
    assert shiftadd.as_quant_ctx(False) is None
    assert shiftadd.as_quant_ctx(None) is None
    assert shiftadd.as_quant_ctx(True).n_bits == 4
    c = shiftadd.QuantCtx(n_bits=3)
    assert shiftadd.as_quant_ctx(c) is c
    with pytest.raises(TypeError):
        shiftadd.as_quant_ctx("pallas")


# ---------------------------------------------------------------------------
# the leftovers the paper evaluation needs: the naive quantizer, the Fig. 2
# shares, the per-layer access report, the shift-add oracles, calibration
# ---------------------------------------------------------------------------

def _codes_pair(x: np.ndarray, n_bits: int):
    q = logquant.log2_quantize(torch.from_numpy(x), n_bits)
    qj = jax_lq.log2_quantize(jnp.asarray(x), n_bits)
    return q, qj


def _edge(x: np.ndarray) -> np.ndarray:
    """Within 1 ulp of 2^(k+1/2): the mantissa fields either side of
    sqrt(2) (3474675 below, 3474676 above)."""
    man = x.view(np.uint32) & 0x7FFFFF
    return (man == 3474675) | (man == 3474676)


# the lattice inputs (n_bits 4) where the two packages' float32 log2 land
# on the two sides of k + 1/2: all within 1 ulp of 2^(k+1/2), where the
# naive form is not the specification (the comparator is)
NAIVE_EDGE_FLIPS = [0.011048543, 0.70710677, 1.4142135, 90.509666]


@pytest.mark.parametrize("n_bits", [2, 4, 8])
def test_log2_quantize_naive_bit_equal(n_bits):
    rng = np.random.default_rng(n_bits)
    normals = (rng.normal(0, 1, 50000)
               * 2.0 ** rng.integers(-12, 12, 50000)).astype(np.float32)
    q = logquant.log2_quantize_naive(torch.from_numpy(normals), n_bits)
    qj = jax_lq.log2_quantize_naive(jnp.asarray(normals), n_bits)
    np.testing.assert_array_equal(q.exp.numpy(), np.asarray(qj.exp))
    np.testing.assert_array_equal(q.sign.numpy(), np.asarray(qj.sign))
    assert q.exp.dtype == q.sign.dtype == torch.int8

    lat = lattice(n_bits)
    t = torch.from_numpy(lat)
    q = logquant.log2_quantize_naive(t, n_bits)
    qj = jax_lq.log2_quantize_naive(jnp.asarray(lat), n_bits)
    # XLA on the CPU reads subnormals as zero (see test_torch_kernels)
    sub = subnormal(t)
    differ = (q.exp.numpy() != np.asarray(qj.exp)) & ~sub
    assert (_edge(lat) | ~differ).all(), lat[differ & ~_edge(lat)]
    if n_bits == 4:
        np.testing.assert_allclose(np.sort(np.abs(lat[differ]))[::2],
                                   NAIVE_EDGE_FLIPS, rtol=1e-7)
    daz = negative_subnormal(t)
    np.testing.assert_array_equal(q.sign.numpy()[~daz],
                                  np.asarray(qj.sign)[~daz])
    # away from the edges the naive form equals the comparator
    exact = logquant.log2_quantize(t, n_bits)
    same = ~_edge(lat) & ~sub
    np.testing.assert_array_equal(q.exp.numpy()[same],
                                  exact.exp.numpy()[same])


@pytest.mark.parametrize("n_bits", [2, 4, 8])
@pytest.mark.parametrize("size", [0, 1, 255, 256, 100003])
def test_fractions_and_access_report_bit_equal(n_bits, size):
    """The integer counts exact and equal; Fig. 2's negative share (a
    float32 division) and the pruned shares (``jnp.mean``) equal; the
    savings fractions within 1e-7."""
    rng = np.random.default_rng(size + n_bits)
    x = (rng.normal(0, 1, size) * 2.0 ** rng.integers(-9, 4, size)
         ).astype(np.float32)
    x[: size // 7] = 0.0                       # pruned runs, dead tiles
    q, qj = _codes_pair(x, n_bits)
    assert (float(logquant.negative_fraction(q, n_bits))
            == float(jax_lq.negative_fraction(qj, n_bits)))
    if size:
        assert (float(logquant.pruned_fraction(q, n_bits))
                == float(jax_lq.pruned_fraction(qj, n_bits)))
    for tile_k in (256, 7):
        r = access_model.weight_access_report(q, n_bits, tile_k=tile_k)
        rj = jax_access.weight_access_report(qj, n_bits, tile_k=tile_k)
        for f in ("element_bits", "tile_bits", "baseline_bits"):
            got = getattr(r, f)
            assert got.dtype == torch.int64
            assert int(got) == int(getattr(rj, f)), f
        for f in ("savings_element", "savings_tile", "pruned_fraction"):
            want = float(getattr(rj, f))
            if size or f != "pruned_fraction":
                assert abs(float(getattr(r, f)) - want) <= 1e-7, f


def test_fractions_of_all_pruned_codes():
    x = np.zeros(300, np.float32)
    q, qj = _codes_pair(x, 4)
    assert float(logquant.negative_fraction(q)) == 0.0
    assert float(logquant.pruned_fraction(q)) == 1.0
    r = access_model.weight_access_report(q)
    rj = jax_access.weight_access_report(qj)
    assert int(r.tile_bits) == int(rj.tile_bits) == 0
    assert float(r.savings_tile) == float(rj.savings_tile)


@pytest.mark.parametrize("n_bits", [2, 4, 5])
def test_shift_product_and_elementwise_bit_equal(n_bits):
    """Every int8 weight against every exponent code, the sentinel and
    +-emax included, both signs; then the oracle GEMM."""
    lo, hi = -(1 << (n_bits - 1)), (1 << (n_bits - 1)) - 1
    e = np.arange(lo, hi + 1, dtype=np.int8)
    w = np.arange(-128, 128, dtype=np.int8)
    ee = np.repeat(e, w.size)
    ww = np.tile(w, e.size)
    ss = np.where(np.arange(ee.size) % 2 == 0, 1, -1).astype(np.int8)
    q = logquant.LogQuantized(torch.from_numpy(ee), torch.from_numpy(ss))
    qj = jax_lq.LogQuantized(jnp.asarray(ee), jnp.asarray(ss))
    got = shiftadd.shift_product(torch.from_numpy(ww), q, n_bits)
    want = np.asarray(jax_sa.shift_product(jnp.asarray(ww), qj, n_bits))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    assert (got.numpy()[ee == lo] == 0).all()

    rng = np.random.default_rng(n_bits)
    wk = rng.integers(-128, 128, (48, 24)).astype(np.int8)
    ek = rng.integers(lo, hi + 1, (3, 5, 48)).astype(np.int8)
    sk = rng.choice(np.array([-1, 1], np.int8), (3, 5, 48))
    q = logquant.LogQuantized(torch.from_numpy(ek), torch.from_numpy(sk))
    qj = jax_lq.LogQuantized(jnp.asarray(ek), jnp.asarray(sk))
    y = shiftadd.shiftadd_matmul_elementwise(q, torch.from_numpy(wk), n_bits)
    yj = jax_sa.shiftadd_matmul_elementwise(qj, jnp.asarray(wk), n_bits)
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    assert y.shape == (3, 5, 24) and y.dtype == torch.int32
    # and the plane form, which the CUDA kernel computes, agrees with it
    # up to 4 bits (ROADMAP: below -7 no plane reaches)
    if n_bits <= 4:
        planes = bitplane.to_bitplanes(torch.from_numpy(wk))
        flat = logquant.LogQuantized(q.exp.reshape(-1, 48),
                                     q.sign.reshape(-1, 48))
        np.testing.assert_array_equal(
            shiftadd.shiftadd_matmul_bitplane(flat, planes, n_bits).numpy(),
            y.reshape(-1, 24).numpy())


def test_shiftadd_matmul_exact_close():
    rng = np.random.default_rng(4)
    wk = rng.integers(-128, 128, (64, 40)).astype(np.int8)
    x = rng.normal(0, 1, (6, 64)).astype(np.float32)
    q, qj = _codes_pair(x, 4)
    y = shiftadd.shiftadd_matmul_exact(q, torch.from_numpy(wk))
    yj = np.asarray(jax_sa.shiftadd_matmul_exact(qj, jnp.asarray(wk)))
    assert y.dtype == torch.float32 and y.shape == (6, 40)
    np.testing.assert_allclose(y.numpy(), yj, rtol=2e-5,
                               atol=2e-5 * np.abs(yj).max())


@pytest.mark.parametrize("size,percentile", [
    (7, 99.9), (1000, 99.9), (1001, 50.0), (4096, 100.0), (4096, 0.0),
    ((1 << 24) + 12345, 99.9)])
def test_calibrate_act_scale_close(size, percentile):
    """Within 1e-6 relative, on more than 2^24 elements too (where
    ``torch.quantile`` refuses its input)."""
    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, size).astype(np.float32)
    got = shiftadd.calibrate_act_scale(torch.from_numpy(x), percentile)
    want = float(jax_sa.calibrate_act_scale(jnp.asarray(x), percentile))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * want
    zero = shiftadd.calibrate_act_scale(torch.zeros(10))
    assert float(zero) == float(jax_sa.calibrate_act_scale(jnp.zeros(10)))
