"""The port's kernels K1 (LOG2 quantizer) and K2 (plane-skipping bit-plane
GEMM) held against the JAX package.

The plain versions, the oracles and the skip accounting are bit-equal to
the reference's (Pallas in interpret mode, the jnp forms and the jnp
oracles), and the wrappers check what they are given.  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import log2_quantize as jax_log2_quantize
from repro.core import quantize_weights as jax_quantize_weights
from repro.core import to_bitplanes as jax_to_bitplanes
from repro.core.shiftadd import shiftadd_matmul_bitplane as jax_bitplane
from repro.kernels import bitplane_matmul_pallas, log2_quantize_pallas
from repro.kernels.bitplane_matmul import ops as jax_bm_ops
from repro.kernels.bitplane_matmul.ref import bitplane_matmul_ref as jax_bm_ref
from repro.kernels.log2quant.ref import log2_quantize_ref as jax_l2_ref
from repro_torch.core.logquant import LogQuantized, log2_quantize
from repro_torch.core.shiftadd import shiftadd_matmul_bitplane
from repro_torch.kernels import _build
from repro_torch.kernels.bitplane_matmul import ops as bm_ops
from repro_torch.kernels.bitplane_matmul.ref import bitplane_matmul_ref
from repro_torch.kernels.log2quant import ops as l2_ops
from repro_torch.kernels.log2quant.ref import log2_quantize_ref

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}


def _f32_from_bits(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def lattice(seed: int = 0) -> np.ndarray:
    """Special values, the sqrt(2) comparator's edge mantissas 3474675 and
    3474676 at many exponents and both signs, subnormals, and random
    magnitudes over 40 octaves (f32)."""
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-38, -1e-38,
                        2.0 ** -8, 2.0 ** 7, 1.5, -1.5, 1.0, -1.0],
                       np.float32)
    fields = np.arange(100, 160, dtype=np.uint32)
    edges = [_f32_from_bits((fields << 23) | m) for m in (3474675, 3474676)]
    edges = np.concatenate(edges + [-e for e in edges])
    subnormal = _f32_from_bits([1, 0x7FFFFF, 0x400000, 0x80000001])
    rng = np.random.default_rng(seed)
    rand = (rng.normal(0, 1, 700) * 2.0 ** rng.integers(-20, 20, 700))
    return np.concatenate([special, edges, subnormal,
                           rand.astype(np.float32)])


def as_pair(x_f32: np.ndarray, dtype: str):
    """The same values in both frameworks: cast in torch, then carry the
    exact bits across to JAX."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(x_f32).to(tdt)
    if dtype == "bf16":
        j = jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    else:
        j = jnp.asarray(t.numpy()).astype(jdt)
    return t, j


# ---------------------------------------------------------------------------
# K1 — LOG2 quantizer
# ---------------------------------------------------------------------------

def subnormal(t: torch.Tensor) -> np.ndarray:
    bits = t.float().view(torch.int32).numpy().view(np.uint32)
    return ((bits >> 23) & 0xFF == 0) & (bits & 0x7FFFFF != 0)


def negative_subnormal(t: torch.Tensor) -> np.ndarray:
    bits = t.float().view(torch.int32).numpy().view(np.uint32)
    return subnormal(t) & (bits >> 31 == 1)


@pytest.mark.parametrize("n_bits", range(2, 9))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_log2quant_plain_bit_equal_to_reference(dtype, n_bits):
    """Bit-equal exponents everywhere; bit-equal signs everywhere but at
    negative subnormal inputs.  There the port follows the specification
    (sign -1 iff x < 0), while XLA on the CPU may treat subnormals as zero
    in ``x < 0`` and give +1.  Both prune such a value to the sentinel, so
    it contributes nothing downstream (logged in ROADMAP.md queue 3)."""
    t, j = as_pair(lattice(n_bits), dtype)
    q = log2_quantize(t, n_bits)
    qj = jax_log2_quantize(j, n_bits)
    e_k, s_k = log2_quantize_pallas(j, n_bits=n_bits, interpret=True)
    daz = negative_subnormal(t)
    assert (q.exp.numpy()[daz] == -(1 << (n_bits - 1))).all()
    assert (q.sign.numpy()[daz] == -1).all()
    for e, s in [(qj.exp, qj.sign), (e_k, s_k)]:
        np.testing.assert_array_equal(q.exp.numpy(), np.asarray(e))
        np.testing.assert_array_equal(q.sign.numpy()[~daz],
                                      np.asarray(s)[~daz])
    # the CPU tensor takes the wrapper's plain version
    w = l2_ops.log2quant(t, n_bits)
    assert torch.equal(w.exp, q.exp) and torch.equal(w.sign, q.sign)
    assert q.exp.dtype == q.sign.dtype == torch.int8


@pytest.mark.parametrize("n_bits", [2, 4, 7, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_log2quant_oracle_matches_reference_oracle(dtype, n_bits):
    """The frexp oracles of both packages agree; below 8 bits the oracle
    also equals the comparator.  At 8 bits a subnormal's true exponent
    (-126 and below) fits the range: ``torch.frexp`` finds it, while XLA
    on the CPU may read the subnormal as zero (see the test above), so
    subnormal inputs are left out of the comparison there."""
    t, j = as_pair(lattice(10 + n_bits), dtype)
    e, s = log2_quantize_ref(t, n_bits)
    ej, sj = jax_l2_ref(j, n_bits)
    daz = negative_subnormal(t)      # see the test above
    sub = subnormal(t) if n_bits == 8 else np.zeros_like(daz)
    np.testing.assert_array_equal(e.numpy()[~sub], np.asarray(ej)[~sub])
    np.testing.assert_array_equal(s.numpy()[~daz], np.asarray(sj)[~daz])
    if n_bits < 8:
        q = log2_quantize(t, n_bits)
        assert torch.equal(e, q.exp) and torch.equal(s, q.sign)


def test_log2quant_shapes_and_sign_rules():
    x = torch.tensor([[-0.0, float("nan"), -1e-30], [-2.0, 3.0, 0.0]])
    q = l2_ops.log2quant(x)
    assert q.exp.shape == x.shape
    assert q.sign.tolist() == [[1, 1, -1], [-1, 1, 1]]
    assert q.exp.tolist() == [[-8, -8, -8], [1, 2, -8]]
    empty = l2_ops.log2quant(torch.zeros((0, 5)))
    assert empty.exp.shape == (0, 5)


def test_log2quant_wrapper_rejects_what_the_kernel_does_not_take():
    before = l2_ops.log2quant.launches
    with pytest.raises(TypeError):
        l2_ops.log2quant(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        l2_ops.log2quant(torch.zeros(4), n_bits=9)
    with pytest.raises(ValueError):
        l2_ops.log2quant(torch.zeros(4), n_bits=1)
    l2_ops.log2quant(torch.zeros(4))          # CPU: plain version, no launch
    assert l2_ops.log2quant.launches == before


# ---------------------------------------------------------------------------
# K2 — plane-skipping bit-plane GEMM
# ---------------------------------------------------------------------------

def _gemm_case(m, k, n, seed, zero_frac=0.1, scale=0.5):
    """Codes, planes and int8 weights made by the JAX package, as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, scale, (m, k)).astype(np.float32)
    x[rng.random((m, k)) < zero_frac] = 0.0
    q = jax_log2_quantize(jnp.asarray(x))
    w = jax_quantize_weights(jnp.asarray(
        rng.normal(0, 0.1, (k, n)).astype(np.float32)), channel_axis=-1)
    return (np.asarray(q.exp), np.asarray(q.sign),
            np.asarray(jax_to_bitplanes(w.q)), np.asarray(w.q))


def _extreme_case():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.normal(0, 1e-3, (32, 64)),      # deeply negative exponents
        rng.normal(0, 100.0, (32, 64)),     # positive exponents (left shift)
        np.zeros((32, 64)),                 # pruned
    ], axis=1).astype(np.float32)
    q = jax_log2_quantize(jnp.asarray(x))
    w = jax_quantize_weights(jnp.asarray(
        rng.normal(0, 0.1, (192, 64)).astype(np.float32)), channel_axis=-1)
    return (np.asarray(q.exp), np.asarray(q.sign),
            np.asarray(jax_to_bitplanes(w.q)), np.asarray(w.q))


def _pruned_case():
    q = jax_log2_quantize(jnp.zeros((128, 128), jnp.float32))
    wq = jnp.ones((128, 128), jnp.int8)
    return (np.asarray(q.exp), np.asarray(q.sign),
            np.asarray(jax_to_bitplanes(wq)), np.asarray(wq))


GEMM_CASES = {
    "8x32x16": lambda: _gemm_case(8, 32, 16, 56),
    "96x200x130": lambda: _gemm_case(96, 200, 130, 426),
    "128x128x128": lambda: _gemm_case(128, 128, 128, 384),
    "1x7x3": lambda: _gemm_case(1, 7, 3, 11),
    "130x260x100": lambda: _gemm_case(130, 260, 100, 490),
    "extreme_exponents": _extreme_case,
    "fully_pruned_tile": _pruned_case,
}


@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_bitplane_matmul_plain_and_oracle_bit_equal_to_reference(case):
    exp, sign, planes, wq = GEMM_CASES[case]()
    y_pallas = np.asarray(bitplane_matmul_pallas(
        jnp.asarray(exp), jnp.asarray(sign), jnp.asarray(planes),
        interpret=True))
    y_jnp = np.asarray(jax_bitplane(
        jax_log2_quantize(jnp.zeros(1))._replace(exp=jnp.asarray(exp),
                                                 sign=jnp.asarray(sign)),
        jnp.asarray(planes)))
    y_jref = np.asarray(jax_bm_ref(jnp.asarray(exp), jnp.asarray(sign),
                                   jnp.asarray(wq)))
    te, ts, tp = (torch.from_numpy(np.array(a)) for a in (exp, sign, planes))
    y_plain = shiftadd_matmul_bitplane(LogQuantized(te, ts), tp)
    y_oracle = bitplane_matmul_ref(te, ts, torch.from_numpy(np.array(wq)))
    y_wrap = bm_ops.bitplane_matmul(te, ts, tp)
    for y in (y_jnp, y_jref, y_plain.numpy(), y_oracle.numpy(),
              y_wrap.numpy()):
        np.testing.assert_array_equal(y, y_pallas)
    assert y_plain.dtype == y_oracle.dtype == torch.int32
    if case == "fully_pruned_tile":
        assert not y_plain.any()


@pytest.mark.parametrize("shape,block", [
    ((130, 260), (128, 128)), ((1, 7), (128, 128)), ((256, 512), (128, 128)),
    ((100, 300), (64, 64)), ((128, 384), (128, 256))])
def test_skip_table_and_traffic_counts_equal_reference(shape, block):
    rng = np.random.default_rng(shape[0] * shape[1])
    exp = rng.integers(-8, 8, shape).astype(np.int8)
    exp[: shape[0] // 2, : shape[1] // 3] = -8          # a pruned corner
    exp[shape[0] // 2:, shape[1] // 3:] = np.minimum(
        exp[shape[0] // 2:, shape[1] // 3:], -3)         # cold activations
    bm, bk = block
    pm, pk = (-shape[0]) % bm, (-shape[1]) % bk
    exp_p = np.pad(exp, ((0, pm), (0, pk)), constant_values=-8)
    table_j = np.asarray(jax_bm_ops._skip_table(jnp.asarray(exp_p), bm, bk,
                                                4, 8))
    table_t = bm_ops._skip_table(torch.from_numpy(exp_p), bm, bk, 4, 8)
    np.testing.assert_array_equal(table_t.numpy(), table_j)
    f_j, t_j = jax_bm_ops.plane_traffic_counts(jnp.asarray(exp),
                                               block_m=bm, block_k=bk)
    f_t, t_t = bm_ops.plane_traffic_counts(torch.from_numpy(exp),
                                           block_m=bm, block_k=bk)
    assert float(f_t) == float(f_j) and float(t_t) == float(t_j)
    frac_j = float(jax_bm_ops.plane_traffic_fraction(
        jnp.asarray(exp), block_m=bm, block_k=bk))
    frac_t = float(bm_ops.plane_traffic_fraction(
        torch.from_numpy(exp), block_m=bm, block_k=bk))
    assert frac_t == frac_j


def test_bitplane_wrapper_rejects_what_the_kernel_does_not_take():
    exp = torch.zeros((4, 16), dtype=torch.int8)
    planes = torch.zeros((8, 16, 8), dtype=torch.uint8)
    before = bm_ops.bitplane_matmul.launches
    with pytest.raises(TypeError):
        bm_ops.bitplane_matmul(exp.int(), exp, planes)
    with pytest.raises(TypeError):
        bm_ops.bitplane_matmul(exp, exp, planes.int())
    with pytest.raises(ValueError):
        bm_ops.bitplane_matmul(exp, exp[:, :8], planes)
    with pytest.raises(ValueError):
        bm_ops.bitplane_matmul(exp, exp, planes[:, :8])
    with pytest.raises(ValueError):
        bm_ops.bitplane_matmul(exp, exp, planes, n_bits=6)
    assert bm_ops.bitplane_matmul(exp, exp, planes).shape == (4, 8)
    assert bm_ops.bitplane_matmul.launches == before


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_build_command_targets_sm90a_from_repo_sources():
    srcs = {p.stem: p for p in _build.sources()}
    assert set(srcs) >= {"log2quant", "bitplane_matmul"}
    cmd = _build.nvcc_command("nvcc", srcs["log2quant"], _build.BUILD_DIR
                              / "x.so")
    joined = " ".join(cmd)
    for flag in ("-O3", "-std=c++17", "-shared", "-Xcompiler -fPIC",
                 "-gencode arch=compute_90a,code=sm_90a"):
        assert flag in joined
    path = _build.library_path(srcs["log2quant"])
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path != _build.library_path(srcs["bitplane_matmul"])


def test_library_path_follows_the_headers_beside_the_source(tmp_path):
    """A source that includes a ``csrc/*.cuh`` gets a new library name
    when the header changes, so a stale library is never loaded; editing
    the source does it too, and an unchanged tree keeps its name."""
    csrc = tmp_path / "walk" / "csrc"
    csrc.mkdir(parents=True)
    src, header = csrc / "k.cu", csrc / "walk.cuh"
    src.write_text('#include "walk.cuh"\nextern "C" int f() { return W; }\n')
    header.write_text("#define W 1\n")
    first = _build.library_path(src)
    assert first == _build.library_path(src)
    assert first.parent == _build.BUILD_DIR and first.name.startswith("k-")
    header.write_text("#define W 2\n")
    second = _build.library_path(src)
    assert second != first
    (csrc / "more.cuh").write_text("// another header\n")
    assert _build.library_path(src) != second
    src.write_text(src.read_text() + "// edited\n")
    assert _build.library_path(src) not in (first, second)


def test_library_path_follows_the_shared_include_headers(tmp_path,
                                                         monkeypatch):
    """A header in ``kernels/include/`` (the LOG2 rule K1 and K2 share) is
    on every build's include path and in every library's name."""
    include = tmp_path / "include"
    include.mkdir()
    monkeypatch.setattr(_build, "INCLUDE_DIR", include)
    src = {p.stem: p for p in _build.sources()}["bitplane_matmul"]
    cmd = _build.nvcc_command("nvcc", src, tmp_path / "x.so")
    assert cmd[cmd.index("-I") + 1] == str(include)
    first = _build.library_path(src)
    (include / "rule.cuh").write_text("#define R 1\n")
    second = _build.library_path(src)
    assert second != first
    (include / "rule.cuh").write_text("#define R 2\n")
    assert _build.library_path(src) not in (first, second)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
