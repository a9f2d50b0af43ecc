"""The port's core (``repro_torch.core``) held against the JAX package's
(``repro.core``) on the same numpy inputs: weight quantization, bit-planes,
packing, ``needed_bits``, dequantization and the quantized projection are
bit-equal (the projection's int32 GEMM output and its float output)."""

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
