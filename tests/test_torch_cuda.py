"""The port's CUDA kernels against their plain versions, on the card:
K1 (LOG2 quantizer) and K2 (bit-plane GEMM, fed codes or quantizing x /
act_scale in its prologue, on unpacked or packed planes, each body)
bit-equal, K3 (paged-attention
decode) within the reference's tolerances (f32 ``rtol=2e-5, atol=2e-6``;
bf16 ``atol=2e-2`` on the merged output), with trash-page poison bitwise
invisible on live rows, and K4 (paged-attention decode over the
log2-quantized pool) within f32 ``rtol=2e-5, atol=2e-6`` for q in f32 and
bf16 (both widen q and keep ``p`` in f32), with trash-page codes and
scales and the tail ring's dead rows bitwise invisible.  Both kernels are
also held at the serving path's geometry (page_len 16, 32 table columns,
rows up to 512 tokens, so every warp of a block walks several pages), and
there at D = 128 and R = 8, and at qwen3-32b's (8, 8, 128) and
musicgen-medium's (24, 1, 64).  K2 is also held at mamba2-780m's and
qwen3-32b's largest projection shapes; the mamba smoke config's serving
programs (scheduler ticks with SSM snapshots, the one-shot generate), the
deepseek-moe smoke config's (ticks that overflow expert capacity) and the
qwen3 smoke config's (``qk_norm``) as CUDA graphs against
``engine.eager()``.  K1's list call (``log2quant_many``) is held on
ragged lists, misaligned views, lists longer than one launch and mixed
dtypes, replayed from a CUDA graph, and on the paper nets' recorded GEMM
inputs (narrow, AlexNet at its size) in one launch a net, bit-equal to
its plain version.  Training: one f32 smoke train step (smollm, mamba2,
deepseek-moe) on the card against the host, and the flash-attention
backward (``FlashAttention``) against torch autograd through the plain
chunked forward, f32 and bf16, with no score-shaped tensor saved.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  The file imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from repro_torch.core.bitplane import pack_planes, to_bitplanes
from repro_torch.core.logquant import (LogQuantized, code_dtype,
                                      log2_quantize, quantize_page_codes,
                                      scale_exponent)
from repro_torch.core.shiftadd import shiftadd_matmul_bitplane
from repro_torch.core.wquant import quantize_weights
from repro_torch.kernels.bitplane_matmul import ops as bm_ops
from repro_torch.kernels.bitplane_matmul.ref import bitplane_matmul_ref
from repro_torch.kernels.log2quant import ops as l2_ops
from repro_torch.kernels.paged_attention import ops as pa_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _lattice() -> torch.Tensor:
    specials = [0.0, -0.0, math.inf, -math.inf, math.nan, 1e-38, -1e-38,
                2.0 ** -8, 2.0 ** 7, 1.5, -1.5]
    fields = torch.arange(100, 160, dtype=torch.int32)
    edges = torch.cat([((fields << 23) | m).view(torch.float32)
                       for m in (3474675, 3474676)])
    sub = torch.tensor([1, 0x7FFFFF], dtype=torch.int32).view(torch.float32)
    g = torch.Generator().manual_seed(0)
    rand = torch.randn(999, generator=g) * torch.exp2(
        torch.randint(-20, 20, (999,), generator=g).float())
    return torch.cat([torch.tensor(specials), edges, -edges, sub, -sub, rand])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_log2quant_kernel_bit_equal_to_plain(cuda, dtype):
    lat = _lattice().to(dtype).to(cuda)
    for n_bits in range(2, 9):
        for x in (lat, lat[1:], lat[:5], lat[:1200].reshape(40, 30)):
            before = l2_ops.log2quant.launches
            q = l2_ops.log2quant(x, n_bits)
            ref = log2_quantize(x, n_bits)
            torch.cuda.synchronize()
            assert l2_ops.log2quant.launches == before + 1
            assert q.exp.shape == x.shape
            assert torch.equal(q.exp, ref.exp)
            assert torch.equal(q.sign, ref.sign)


def _ragged(dtype, cuda, shift=0):
    """The lattice cut into entries of 0, 1, 3, 15, 16, 17, 1000 and 7 x 13
    elements, then the whole lattice; with ``shift`` 1..3 each entry is a
    contiguous view at that storage offset (a pointer off 16 bytes)."""
    lat = _lattice().to(dtype).to(cuda)
    out, o = [], 0
    for shape in [(0,), (1,), (3,), (15,), (16,), (17,), (1000,), (7, 13)]:
        n = math.prod(shape)
        base = torch.cat([lat, lat])[o:o + n + shift].clone()
        x = base[shift:].view(shape)
        assert x.is_contiguous() and x.storage_offset() == shift
        out.append(x)
        o += n
    return out + [lat]


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_log2quant_many_kernel_bit_equal_to_plain(cuda, dtype, shift):
    """Ragged lists, empty and one-element entries, misaligned views: one
    launch for the list, each view and the flat buffers bit-equal to the
    plain version."""
    xs = _ragged(dtype, cuda, shift)
    for n_bits in range(2, 9):
        before = l2_ops.log2quant.launches
        flat, views = l2_ops.log2quant_many(xs, n_bits)
        torch.cuda.synchronize()
        assert l2_ops.log2quant.launches == before + 1
        for x, v in zip(xs, views):
            ref = log2_quantize(x, n_bits)
            assert v.exp.shape == x.shape
            assert torch.equal(v.exp, ref.exp)
            assert torch.equal(v.sign, ref.sign)
        ref = log2_quantize(torch.cat([x.reshape(-1) for x in xs]), n_bits)
        assert torch.equal(flat.exp, ref.exp)
        assert torch.equal(flat.sign, ref.sign)


def test_log2quant_many_long_and_mixed_lists(cuda):
    """210 entries (the decode step's activations) take more than one
    launch; a list of three dtypes one launch per dtype; bit-equal."""
    g = torch.Generator(device=cuda).manual_seed(3)
    xs = [torch.randn((4, (576, 1536)[i % 7 == 6]), generator=g, device=cuda)
          for i in range(210)]
    lat = _lattice().to(cuda)
    mixed = [lat[:700].to(dt) for dt in (torch.float32, torch.bfloat16,
                                         torch.float16)] * 2 + [lat[1:]]
    for lst, launches in ((xs, -(-210 // l2_ops.MAX_ENTRIES)), (mixed, 3)):
        before = l2_ops.log2quant.launches
        flat, views = l2_ops.log2quant_many(lst)
        torch.cuda.synchronize()
        assert l2_ops.log2quant.launches == before + launches
        for x, v in zip(lst, views):
            ref = log2_quantize(x)
            assert torch.equal(v.exp, ref.exp)
            assert torch.equal(v.sign, ref.sign)
        assert torch.equal(flat.exp, torch.cat([v.exp.reshape(-1)
                                                for v in views]))


def test_log2quant_many_graph_replay_equals_eager(cuda):
    """The table travels in the kernel parameters: a captured list call
    replays into its buffers what the eager call writes."""
    xs = _ragged(torch.float32, cuda, 1) + _ragged(torch.bfloat16, cuda)
    eager, _ = l2_ops.log2quant_many(xs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        l2_ops.log2quant_many(xs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        flat, _ = l2_ops.log2quant_many(xs)
    flat.exp.fill_(0)
    flat.sign.fill_(0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(flat.exp, eager.exp)
    assert torch.equal(flat.sign, eager.sign)


def _gemm(m, k, n, seed, scale=0.5, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g) * scale
    x[torch.rand((m, k), generator=g) < 0.1] = 0.0
    q = log2_quantize(x)
    w = quantize_weights(torch.randn((k, n), generator=g) * 0.1,
                         channel_axis=-1)
    return (t.to(device) for t in (q.exp, q.sign, to_bitplanes(w.q), w.q))


@pytest.mark.parametrize("m,k,n", [(8, 32, 16), (96, 200, 130),
                                   (128, 128, 128), (1, 7, 3),
                                   (130, 260, 100), (4, 576, 192),
                                   (256, 1536, 576)])
@pytest.mark.parametrize("scale", [0.5, 0.02, 50.0])
def test_bitplane_kernel_bit_equal_to_plain(cuda, m, k, n, scale):
    exp, sign, planes, wq = _gemm(m, k, n, m + k + n, scale)
    before = bm_ops.bitplane_matmul.launches
    y = bm_ops.bitplane_matmul(exp, sign, planes)
    torch.cuda.synchronize()
    assert bm_ops.bitplane_matmul.launches == before + 1
    assert torch.equal(y, shiftadd_matmul_bitplane(LogQuantized(exp, sign),
                                                   planes))
    assert torch.equal(y, bitplane_matmul_ref(exp, sign, wq))


def test_bitplane_kernel_fully_pruned_tile_is_zero(cuda):
    q = log2_quantize(torch.zeros((128, 128), device=cuda))
    planes = to_bitplanes(torch.ones((128, 128), dtype=torch.int8,
                                     device=cuda))
    assert not bm_ops.bitplane_matmul(q.exp, q.sign, planes).any()
    assert float(bm_ops.plane_traffic_fraction(q.exp)) == 0.0


def test_wrappers_refuse_non_contiguous_cuda_input(cuda):
    x = torch.randn((8, 16), device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        l2_ops.log2quant(x)
    exp, sign, planes, _ = _gemm(4, 16, 8, 0)
    with pytest.raises(ValueError, match="contiguous"):
        bm_ops.bitplane_matmul(exp, sign, planes.transpose(1, 2)
                               .contiguous().transpose(1, 2))


def _fused(m, k, n, seed, dtype=torch.bfloat16, scale=1.0, device="cuda"):
    """x (m, k) with zeros, int8 weights as (int8, unpacked, packed)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g) * scale
    x[torch.rand((m, k), generator=g) < 0.1] = 0.0
    w = quantize_weights(torch.randn((k, n), generator=g) * 0.1,
                         channel_axis=-1).q
    planes = to_bitplanes(w)
    return (x.to(dtype).to(device), w.to(device), planes.to(device),
            pack_planes(planes, axis=0).to(device))


@pytest.mark.parametrize("tensor_cores", [None, False, True])
@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 63, 64, 127, 128, 130])
def test_fused_kernel_bit_equal_to_plain(cuda, m, layout, tensor_cores):
    """Around the integer / tensor-core switch (N = 384 crosses it at 128
    rows), both layouts, each body and the wrapper's choice: the output
    equals the plain version and the direct-shift oracle, the codes K1's
    plain version."""
    for k, n, dtype, act in ((576, 192, torch.bfloat16, 0.37),
                             (576, 384, torch.bfloat16, 2.0 ** -3),
                             (200, 40, torch.float32, 1.0)):
        x, w, unpacked, packed = _fused(m, k, n, m + k + n, dtype)
        planes = packed if layout == "packed" else unpacked
        a = torch.tensor(act, device=cuda)
        for n_bits in (2, 4, 5):
            if tensor_cores and n_bits > 4:
                continue
            want, q = bm_ops.log2_bitplane_matmul_plain(x, a, planes, n_bits)
            before = bm_ops.bitplane_matmul.launches
            y, got = bm_ops.log2_bitplane_matmul(
                x, a, planes, n_bits, codes=True, tensor_cores=tensor_cores)
            torch.cuda.synchronize()
            assert bm_ops.bitplane_matmul.launches == before + 1
            assert torch.equal(y, want)
            assert torch.equal(got.exp, q.exp)
            assert torch.equal(got.sign, q.sign)
            if n_bits <= 4:
                assert torch.equal(y, bitplane_matmul_ref(q.exp, q.sign, w,
                                                          n_bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_codes_equal_k1_plain_on_the_lattice(cuda, dtype):
    """Specials, comparator edges and subnormals through the fused op's
    prologue: its codes are K1's plain version on x / act_scale."""
    lat = _lattice()
    x = lat[: (lat.numel() // 64) * 64].reshape(-1, 64).to(dtype).to(cuda)
    _, _, unpacked, packed = _fused(1, 64, 16, 3)
    for act in (1.0, 0.37, 2.0 ** -3):
        a = torch.tensor(act, device=cuda)
        for n_bits in (2, 3, 4, 5):
            for planes in (unpacked, packed):
                y, got = bm_ops.log2_bitplane_matmul(x, a, planes, n_bits,
                                                     codes=True)
                want, q = bm_ops.log2_bitplane_matmul_plain(x, a, planes,
                                                            n_bits)
                torch.cuda.synchronize()
                assert torch.equal(got.exp, q.exp)
                assert torch.equal(got.sign, q.sign)
                assert torch.equal(y, want)


def test_fused_kernel_fully_pruned_tile_is_zero(cuda):
    x = torch.zeros((128, 128), device=cuda)
    planes = to_bitplanes(torch.ones((128, 128), dtype=torch.int8,
                                     device=cuda))
    a = torch.tensor(1.0, device=cuda)
    for p in (planes, pack_planes(planes, axis=0)):
        for tc in (False, True):
            assert not bm_ops.log2_bitplane_matmul(x, a, p,
                                                   tensor_cores=tc).any()


@pytest.mark.parametrize("m", [4, 256])
def test_fused_kernel_graph_replay_equals_eager(cuda, m):
    x, _, _, packed = _fused(m, 576, 192, 7)
    a = torch.tensor(0.37, device=cuda)
    eager = bm_ops.log2_bitplane_matmul(x, a, packed)
    out = torch.empty_like(eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bm_ops.log2_bitplane_matmul(x, a, packed, out=out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bm_ops.log2_bitplane_matmul(x, a, packed, out=out)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_fused_wrapper_refuses_non_contiguous_cuda_input(cuda):
    x, _, unpacked, packed = _fused(8, 64, 16, 0)
    a = torch.tensor(1.0, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bm_ops.log2_bitplane_matmul(x.t().contiguous().t(), a, unpacked)
    with pytest.raises(ValueError, match="contiguous"):
        bm_ops.log2_bitplane_matmul(
            x, a, packed.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="share one device"):
        bm_ops.log2_bitplane_matmul(x, a.cpu(), unpacked)


def _paged_case(page_len, nb, g, r, d, lengths, dtype, poison, seed,
                device):
    gen = torch.Generator().manual_seed(seed)
    b = len(lengths)
    n_pages = 1 + b * nb
    k = torch.randn((n_pages, page_len, g, d), generator=gen)
    v = torch.randn((n_pages, page_len, g, d), generator=gen)
    k[0] = poison
    v[0] = poison
    table = torch.from_numpy(pa_ops.make_page_table(lengths, nb, page_len))
    q = torch.randn((b, 1, g * r, d), generator=gen)
    lens = torch.tensor(lengths, dtype=torch.int32)
    return (q.to(dtype).to(device), k.to(dtype).to(device),
            v.to(dtype).to(device), table.to(device), lens.to(device))


def _lengths(page_len, nb):
    mx = page_len * nb
    cand = [0, 1, page_len - 1, page_len, page_len + 1, 2 * page_len, mx]
    return [n for n in dict.fromkeys(cand) if 0 <= n <= mx]


@pytest.mark.parametrize("page_len,nb", [(1, 4), (4, 4), (8, 3), (16, 5)])
@pytest.mark.parametrize("g,r", [(1, 1), (2, 2), (1, 3), (3, 3)])
@pytest.mark.parametrize("d", [8, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(cuda, page_len, nb, g, r, d,
                                              dtype):
    q, k, v, table, lens = _paged_case(page_len, nb, g, r, d,
                                       _lengths(page_len, nb), dtype, 1e4,
                                       page_len + g + r + d, cuda)
    b, _, h, _ = q.shape
    live = (lens > 0).cpu()
    for splits in (1, 2, 3, 4):
        pt = torch.nn.functional.pad(table, (0, (-nb) % splits))
        qg = q.reshape(b, g, r, d)
        before = pa_ops.paged_attention.launches
        o, m, l = pa_ops.paged_attention(qg, k, v, pt, lens, splits)
        torch.cuda.synchronize()
        assert pa_ops.paged_attention.launches == before + 1
        po, pm, pl = pa_ops.paged_attention_plain(qg, k, v, pt, lens, splits)
        assert torch.equal(m <= pa_ops.NEG_INF / 2, pm <= pa_ops.NEG_INF / 2)
        if dtype == torch.float32:
            for a, e in ((o, po), (m, pm), (l, pl)):
                torch.testing.assert_close(a, e, rtol=2e-5, atol=2e-6)
        out = pa_ops.merge_split_softmax(m, l, o, axis=2).cpu()
        ref = pa_ops.merge_split_softmax(pm, pl, po, axis=2).cpu()
        assert torch.isfinite(out).all()
        tol = (dict(rtol=2e-5, atol=2e-6) if dtype == torch.float32
               else dict(rtol=0.0, atol=2e-2))
        torch.testing.assert_close(out[live], ref[live], **tol)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_poison_invisible(cuda, splits, dtype):
    lengths = [0, 1, 3, 4, 5, 16]
    live = torch.tensor(lengths) > 0
    outs = []
    for poison in (0.0, 1e4, -1e4):
        q, k, v, table, lens = _paged_case(4, 4, 2, 2, 8, lengths, dtype,
                                           poison, 11, cuda)
        out = pa_ops.paged_decode_attention(q, k, v, table, lens,
                                            splits=splits).cpu()
        assert torch.isfinite(out.float()).all()
        outs.append(out)
    for out in outs[1:]:
        assert torch.equal(out[live], outs[0][live])


def test_paged_attention_kernel_splits_bitwise_in_split_zero(cuda):
    q, k, v, table, lens = _paged_case(4, 4, 2, 2, 8, [4, 7, 8],
                                       torch.float32, 0.0, 24, cuda)
    base = pa_ops.paged_decode_attention(q, k, v, table, lens, splits=1)
    two = pa_ops.paged_decode_attention(q, k, v, table, lens, splits=2)
    assert torch.equal(base, two)


def test_paged_attention_refuses_mixed_dtypes_and_views(cuda):
    q, k, v, table, lens = _paged_case(4, 4, 1, 1, 8, [3, 5], torch.float32,
                                       0.0, 0, cuda)
    qg = q.reshape(2, 1, 1, 8)
    with pytest.raises(TypeError, match="dtype"):
        pa_ops.paged_attention(qg.to(torch.bfloat16), k, v, table, lens, 1)
    with pytest.raises(ValueError, match="contiguous"):
        pa_ops.paged_attention(qg, k, v, table.t().contiguous().t(), lens, 1)


# the serving path's geometry (smollm-135m: page_len 16, G 3, R 3, D 64,
# 32 table columns) with rows long enough to give each of a block's warps
# several pages, plus D = 128 and R = 8 at the same lengths
LONG_LENGTHS = [512, 300, 64, 33, 17, 16, 1, 0]
LONG_GEOS = [(3, 3, 64), (3, 3, 128), (1, 8, 64),
             (8, 8, 128), (24, 1, 64)]     # qwen3-32b's, musicgen-medium's


def _assert_long_partials_close(got, want):
    """f32 partials of rows up to 512 tokens at ``rtol=2e-5, atol=2e-6``:
    m and l as they are, o divided by its split's l.  The unnormalised o
    sums up to 512 products whose f32 rounding alone moves it by more than
    atol: the plain version itself is up to 4.7e-6 (D = 64) and 1.8e-5 (D =
    128) away from the exact f64 partials on these inputs, so only a
    kernel that sums in its exact order could meet atol there; divided by
    l, that error is about 40x smaller."""
    (o, m, l), (po, pm, pl) = got, want
    held = pm > pa_ops.NEG_INF / 2
    torch.testing.assert_close(m, pm, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(l, pl, rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(o[held] / l[held][:, None],
                               po[held] / pl[held][:, None], rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("g,r,d", LONG_GEOS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_long_rows_match_plain(cuda, g, r, d, dtype):
    q, k, v, table, lens = _paged_case(16, 32, g, r, d, LONG_LENGTHS, dtype,
                                       1e4, 3 + g + r + d, cuda)
    b = q.shape[0]
    qg = q.reshape(b, g, r, d)
    live = (lens > 0).cpu()
    for splits in (1, 2, 3, 4):
        pt = torch.nn.functional.pad(table, (0, (-32) % splits))
        o, m, l = pa_ops.paged_attention(qg, k, v, pt, lens, splits)
        torch.cuda.synchronize()
        po, pm, pl = pa_ops.paged_attention_plain(qg, k, v, pt, lens, splits)
        assert torch.equal(m <= pa_ops.NEG_INF / 2, pm <= pa_ops.NEG_INF / 2)
        if dtype == torch.float32:
            _assert_long_partials_close((o, m, l), (po, pm, pl))
        out = pa_ops.merge_split_softmax(m, l, o, axis=2).cpu()
        ref = pa_ops.merge_split_softmax(pm, pl, po, axis=2).cpu()
        assert torch.isfinite(out).all()
        tol = (dict(rtol=2e-5, atol=2e-6) if dtype == torch.float32
               else dict(rtol=0.0, atol=2e-2))
        torch.testing.assert_close(out[live], ref[live], **tol)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_long_rows_poison_invisible(cuda, splits,
                                                           dtype):
    live = torch.tensor(LONG_LENGTHS) > 0
    outs = []
    for poison in (0.0, 1e4, -1e4):
        q, k, v, table, lens = _paged_case(16, 32, 3, 3, 64, LONG_LENGTHS,
                                           dtype, poison, 12, cuda)
        out = pa_ops.paged_decode_attention(q, k, v, table, lens,
                                            splits=splits).cpu()
        assert torch.isfinite(out.float()).all()
        outs.append(out)
    for out in outs[1:]:
        assert torch.equal(out[live], outs[0][live])


def _quant_case(page_len, nb, g, r, d, lengths, n_bits, q_dtype, seed,
                garbage, device):
    """A quantized pool laid out as the scheduler lays it out (codes under
    each page's first-row scale), a tail ring whose active half holds each
    row's newest page exactly; the trash page's codes and scales (up to
    +-127), the ring's other rows and its junk bin are garbage drawn from
    ``garbage``."""
    gen = torch.Generator().manual_seed(seed)
    b = len(lengths)
    n_pages = 1 + b * nb
    k = torch.randn((n_pages, page_len, g, d), generator=gen)
    v = torch.randn((n_pages, page_len, g, d), generator=gen)
    table = torch.from_numpy(pa_ops.make_page_table(lengths, nb, page_len))
    q = torch.randn((b, 1, g * r, d), generator=gen).to(q_dtype)
    pools = []
    junk = torch.Generator().manual_seed(1000 + garbage)
    for x in (k, v):
        se = scale_exponent(x[:, 0], dim=-1)                   # (P, G)
        codes = quantize_page_codes(x, se[:, None, :, None], n_bits)
        lim = 256 if n_bits >= 8 else 128
        codes[0] = torch.randint(-lim, lim, codes[0].shape, generator=junk
                                 ).to(codes.dtype)
        se[0] = torch.randint(-127, 128, se[0].shape, generator=junk)
        tail = torch.randn((b, 2 * page_len + 1, g, d), generator=junk) * 1e3
        for i, n in enumerate(lengths):
            tb = max(n - 1, 0) // page_len
            if table[i, tb]:
                half = (tb % 2) * page_len
                tail[i, half:half + page_len] = x[table[i, tb]]
        pools.append((codes, se, tail))
    (kc, ks, kt), (vc, vs, vt) = pools
    lens = torch.tensor(lengths, dtype=torch.int32)
    return tuple(t.to(device) for t in (q, kc, ks, vc, vs, kt, vt, table,
                                        lens))


@pytest.mark.parametrize("page_len,nb", [(1, 4), (4, 4), (8, 3), (16, 5)])
@pytest.mark.parametrize("g,r", [(1, 1), (2, 2), (1, 3), (3, 3)])
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("n_bits", [2, 4, 8])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_quant_kernel_matches_plain(cuda, page_len, nb, g, r,
                                                    d, n_bits, q_dtype):
    q, kc, ks, vc, vs, _, _, table, lens = _quant_case(
        page_len, nb, g, r, d, _lengths(page_len, nb), n_bits, q_dtype,
        page_len + g + r + d + n_bits, 0, cuda)
    assert kc.dtype == code_dtype(n_bits)
    b = q.shape[0]
    qg = q.reshape(b, g, r, d)
    live = (lens > 0).cpu()
    for splits in (1, 2, 3, 4):
        pt = torch.nn.functional.pad(table, (0, (-nb) % splits))
        before = pa_ops.paged_attention_quant.launches
        o, m, l = pa_ops.paged_attention_quant(qg, kc, ks, vc, vs, pt, lens,
                                               n_bits, splits)
        torch.cuda.synchronize()
        assert pa_ops.paged_attention_quant.launches == before + 1
        po, pm, pl = pa_ops.paged_attention_quant_plain(
            qg, kc, ks, vc, vs, pt, lens, n_bits, splits)
        assert torch.equal(m <= pa_ops.NEG_INF / 2, pm <= pa_ops.NEG_INF / 2)
        for a, e in ((o, po), (m, pm), (l, pl)):
            torch.testing.assert_close(a, e, rtol=2e-5, atol=2e-6)
        out = pa_ops.merge_split_softmax(m, l, o, axis=2).cpu()
        ref = pa_ops.merge_split_softmax(pm, pl, po, axis=2).cpu()
        assert not torch.isnan(out).any()
        torch.testing.assert_close(out[live], ref[live], rtol=2e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("n_bits", [2, 4, 8])
def test_paged_attention_quant_garbage_invisible(cuda, splits, n_bits):
    """Through ``paged_decode_attention_quant`` (floored lengths in K4,
    the newest page from the ring): live rows bitwise the same whatever
    the garbage, no NaN, and within f32 tolerance of the host's plain
    path on the same inputs."""
    lengths = [0, 1, 15, 16, 17, 48]
    live = torch.tensor(lengths) > 0
    outs = []
    for garbage in (0, 1, 2):
        args = _quant_case(16, 4, 3, 3, 64, lengths, n_bits, torch.bfloat16,
                           5, garbage, cuda)
        out = pa_ops.paged_decode_attention_quant(
            *args, n_bits=n_bits, splits=splits).cpu()
        assert not torch.isnan(out.float()).any()
        outs.append(out)
    for out in outs[1:]:
        assert torch.equal(out[live], outs[0][live])
    host = pa_ops.paged_decode_attention_quant(
        *(t.cpu() for t in args), n_bits=n_bits, splits=splits)
    torch.testing.assert_close(outs[-1][live].float(), host[live].float(),
                               rtol=0.0, atol=2e-2)


@pytest.mark.parametrize("g,r,d", LONG_GEOS)
@pytest.mark.parametrize("n_bits", [2, 4, 8])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_quant_kernel_long_rows_match_plain(cuda, g, r, d,
                                                            n_bits, q_dtype):
    q, kc, ks, vc, vs, _, _, table, lens = _quant_case(
        16, 32, g, r, d, LONG_LENGTHS, n_bits, q_dtype, 5 + g + r + d, 0,
        cuda)
    b = q.shape[0]
    qg = q.reshape(b, g, r, d)
    live = (lens > 0).cpu()
    for splits in (1, 2, 3, 4):
        pt = torch.nn.functional.pad(table, (0, (-32) % splits))
        o, m, l = pa_ops.paged_attention_quant(qg, kc, ks, vc, vs, pt, lens,
                                               n_bits, splits)
        torch.cuda.synchronize()
        po, pm, pl = pa_ops.paged_attention_quant_plain(
            qg, kc, ks, vc, vs, pt, lens, n_bits, splits)
        assert torch.equal(m <= pa_ops.NEG_INF / 2, pm <= pa_ops.NEG_INF / 2)
        _assert_long_partials_close((o, m, l), (po, pm, pl))
        out = pa_ops.merge_split_softmax(m, l, o, axis=2).cpu()
        ref = pa_ops.merge_split_softmax(pm, pl, po, axis=2).cpu()
        assert not torch.isnan(out).any()
        torch.testing.assert_close(out[live], ref[live], rtol=2e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("n_bits", [2, 4, 8])
def test_paged_attention_quant_long_rows_garbage_invisible(cuda, splits,
                                                           n_bits):
    live = torch.tensor(LONG_LENGTHS) > 0
    outs = []
    for garbage in (0, 1, 2):
        args = _quant_case(16, 32, 3, 3, 64, LONG_LENGTHS, n_bits,
                           torch.bfloat16, 6, garbage, cuda)
        out = pa_ops.paged_decode_attention_quant(
            *args, n_bits=n_bits, splits=splits).cpu()
        assert not torch.isnan(out.float()).any()
        outs.append(out)
    for out in outs[1:]:
        assert torch.equal(out[live], outs[0][live])


def test_paged_attention_quant_refuses_bad_inputs(cuda):
    q, kc, ks, vc, vs, _, _, table, lens = _quant_case(
        4, 4, 1, 1, 8, [3, 5], 4, torch.float32, 0, 0, cuda)
    qg = q.reshape(2, 1, 1, 8)
    with pytest.raises(TypeError, match="f32 or bf16"):
        pa_ops.paged_attention_quant(qg.half(), kc, ks, vc, vs, table, lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa_ops.paged_attention_quant(qg, kc, ks, vc, vs,
                                     table.t().contiguous().t(), lens)
    with pytest.raises(ValueError, match="one device"):
        pa_ops.paged_attention_quant(qg, kc, ks.cpu(), vc, vs, table, lens)


# ---------------------------------------------------------------------------
# the serving programs as CUDA graphs, against engine.eager()
# ---------------------------------------------------------------------------

GRAPH_BASE = dict(max_slots=3, max_len=64, buckets=(8, 16), tick_steps=4,
                  chunked="auto", chunk_len=8)
GRAPH_PAGED = dict(GRAPH_BASE, paged=True, page_len=4, prefix_cache=True,
                   attn_kernel="pallas", attn_splits=2)
GRAPH_MODES = {
    "dense": (GRAPH_BASE, False),
    "paged_k3": (GRAPH_PAGED, False),
    "kv_quant_k4": (dict(GRAPH_PAGED, kv_quant=True, kv_bits=4), False),
    "quant_stats_k3": (dict(GRAPH_PAGED, quant="pallas", with_stats=True),
                       True),
}


def _graph_prompts(vocab):
    """Eight requests on three slots: a chunk-only first tick, bucketed
    and chunked admissions, retirements, prefix hits with copy on
    write."""
    import numpy as np

    rng = np.random.default_rng(0)

    def tok(n):
        return rng.integers(0, vocab, size=n).astype(np.int32)

    stem = tok(10)
    p = [np.concatenate([stem, tok(3)]), tok(5), tok(21)]
    return p + [np.concatenate([stem, tok(4)]), p[1].copy(),
                np.concatenate([stem, tok(5)]), tok(9), tok(7)]


def _pool_bytes(sched):
    """Every pool byte but those where writes collide (and CUDA picks the
    winner in any order): the trash page and the tail rings' junk bins."""
    out = []
    for layer in sched._pool["layers"]:
        for k, t in sorted(layer.items()):
            if k.endswith("_tail"):
                t = t[:, :, :-1]
            elif sched.paged and "ssm" not in layer:
                t = t[:, 1:]
            out.append(t.clone())
    return out


def _serve_ticks(cfg, params, kw, prompts):
    from repro_torch.serving import ServeConfig, ServeScheduler

    sched = ServeScheduler(cfg, params, ServeConfig(**kw))
    sched.submit(prompts[2], max_new=6)
    log = []
    while sched.pending:
        if len(log) == 1:
            for p in prompts[:2] + prompts[3:]:
                sched.submit(p, max_new=6)
        assert sched.step_tick()
        log.append((sched._pool["length"].cpu(),
                    sched._table.copy() if sched.paged else None,
                    _pool_bytes(sched)))
    results = [(r.tokens, repr(r.plane_traffic_fraction),
                repr(r.element_traffic_fraction)) for r in sched.run()]
    return sched, log, results


@pytest.mark.parametrize("mode", list(GRAPH_MODES))
def test_graph_tick_bit_equal_to_eager(cuda, mode):
    """The scheduler's programs replayed as CUDA graphs against the same
    bodies under ``engine.eager()``, bf16 smoke config: tokens, per-request
    stats, and after every tick the lengths, page tables and pool bytes
    equal bit for bit; every program that ran was captured once per
    signature and replayed on every later call."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

    kw, quant = GRAPH_MODES[mode]
    cfg = get_smoke("smollm-135m")
    params = init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    if quant:
        params = quantize_model_params(cfg, params)
    prompts = _graph_prompts(cfg.vocab_size)
    with engine.eager():
        _, elog, eres = _serve_ticks(cfg, params, kw, prompts)
    sched, glog, gres = _serve_ticks(cfg, params, kw, prompts)
    assert gres == eres
    assert len(glog) == len(elog)
    for t, (g, e) in enumerate(zip(glog, elog)):
        assert torch.equal(g[0], e[0]), f"lengths, tick {t}"
        if sched.paged:
            assert np.array_equal(g[1], e[1]), f"table, tick {t}"
        for a, b in zip(g[2], e[2]):
            assert torch.equal(a, b), f"pool bytes, tick {t}"
    stats = sched.compile_stats()
    assert stats["tick"] == stats["chunk"] == stats["mixed"] == 1
    for name, prog in sched.programs().items():
        for entry in prog.entries():
            assert entry.graph is not None and entry.census is not None
            assert entry.replays == entry.calls >= 1, name
    tick = sched.programs()["tick"].entries()[0].census
    if mode == "dense":
        assert tick["paged_attention"] == tick["paged_attention_quant"] == 0
    elif mode == "kv_quant_k4":
        assert tick["paged_attention_quant"] == cfg.n_layers * 4
    else:
        assert tick["paged_attention"] == cfg.n_layers * 4
    assert tick["bitplane_matmul"] == (cfg.n_layers * 7 * 4 if quant else 0)


def test_graph_replay_reads_the_new_table(cuda):
    """A program's static table buffer takes each call's table: a replay
    after a host-side table change reads the new table (K3 in a graph)."""
    from repro_torch.serving import engine

    q, k, v, table, lens = _paged_case(4, 4, 2, 2, 8, [3, 9, 16, 5],
                                       torch.bfloat16, 1e4, 3, cuda)
    prog = engine.Program(
        lambda t, n: (pa_ops.paged_decode_attention(q, k, v, t, n,
                                                    splits=2),),
        name="walk", device=cuda)
    first = prog(table, lens)[0].clone()
    assert torch.equal(first, pa_ops.paged_decode_attention(
        q, k, v, table, lens, splits=2))
    swap = torch.tensor([1, 0, 3, 2], device=cuda)
    table2, lens2 = table[swap].contiguous(), lens[swap].contiguous()
    second = prog(table2.cpu(), lens2.cpu())[0].clone()
    entry = prog.entries()[0]
    assert entry.replays == 2 and entry.census["paged_attention"] == 1
    assert torch.equal(second, pa_ops.paged_decode_attention(
        q, k, v, table2, lens2, splits=2))
    assert not torch.equal(second, first)


@pytest.mark.parametrize("eos", [False, True])
def test_generate_program_bit_equal_to_eager(cuda, eos):
    """The one-shot program (prefill + every decode step, one graph)
    against its body under ``engine.eager()``: tokens and stats equal,
    greedy and with temperature, where both runs draw from equally seeded
    generators and leave them at the same offset."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

    cfg = get_smoke("smollm-135m")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = quantize_model_params(cfg, init_params(cfg, generator=gen,
                                                    device=cuda))
    prompt = torch.randint(0, cfg.vocab_size, (3, 8), generator=gen,
                           device=cuda, dtype=torch.int32)
    eos_id = None
    if eos:
        free = engine.greedy_generate(cfg, params, prompt, 8, quant=True)
        eos_id = int(free[0, 2])
    for temperature in (0.0, 0.7):
        runs = []
        for mode in ("eager", "graph", "graph"):
            g = torch.Generator(device=cuda).manual_seed(5)
            ctx = engine.eager() if mode == "eager" else torch.no_grad()
            with ctx:
                toks, st = engine.greedy_generate(
                    cfg, params, prompt, 8, quant=True, with_stats=True,
                    eos_id=eos_id, temperature=temperature, generator=g)
            runs.append((toks, st, g.get_offset()))
        for toks, st, offset in runs[1:]:
            assert torch.equal(toks, runs[0][0])
            for key in st:
                assert torch.equal(st[key], runs[0][1][key])
            assert offset == runs[0][2]


def test_colliding_page_writes_match_the_host(cuda):
    """Many rows aimed at the trash page: the card resolves them as the
    host's serial scatter does (the last row wins), in every run, for the
    dense pool and for the quantized pool's codes and scales."""
    from repro_torch.models.attention import (_paged_write, _quant_paged_write,
                                              page_slots)

    gen = torch.Generator().manual_seed(4)
    b, s, g, d, pl, n_pages = 8, 16, 3, 64, 16, 9
    table = torch.zeros((b, 4), dtype=torch.int32)
    table[0, :2] = torch.tensor([1, 2])
    pos = (torch.arange(s)[None] + torch.arange(b)[:, None] * 3).to(
        torch.int32)
    keep = torch.rand((b, s), generator=gen) < 0.7
    new = torch.randn((b, s, g, d), generator=gen).to(torch.bfloat16)
    start = pos[:, 0].contiguous()

    def run(dev):
        args = [t.to(dev) for t in (table, pos, keep, new, start)]
        t, p, k, n, st = args
        pool = torch.zeros((n_pages, pl, g, d), dtype=torch.bfloat16,
                           device=dev)
        _paged_write(pool, page_slots(t, p, k, n_pages, pl), n)
        codes = torch.zeros((n_pages, pl, g, d), dtype=torch.int8,
                            device=dev)
        scale = torch.zeros((n_pages, g), dtype=torch.int32, device=dev)
        tail = torch.zeros((b, 2 * pl + 1, g, d), dtype=torch.bfloat16,
                           device=dev)
        _quant_paged_write(codes, scale, tail, t, n, p, k, st, s, 4)
        return pool.cpu(), codes.cpu(), scale.cpu()

    host = run("cpu")
    for _ in range(5):
        for a, e in zip(run(cuda), host):
            assert torch.equal(a, e)


# ---------------------------------------------------------------------------
# mamba2-780m: K2 at its projection shapes, its serving programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tensor_cores", [None, False, True])
@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("m", [4, 8, 128, 256])
def test_fused_kernel_bit_equal_at_mamba_shapes(cuda, m, layout,
                                                tensor_cores):
    """wz/wx (K 1536 -> N 3072) and out_proj (3072 -> 1536): at K = 3072
    a cluster rank owns 3 of the 24 K tiles.  Output equal to the plain
    version and the direct-shift oracle."""
    for k, n in ((1536, 3072), (3072, 1536)):
        x, w, unpacked, packed = _fused(m, k, n, m + k, torch.bfloat16)
        planes = packed if layout == "packed" else unpacked
        a = torch.tensor(0.37, device=cuda)
        want, q = bm_ops.log2_bitplane_matmul_plain(x, a, planes, 4)
        y = bm_ops.log2_bitplane_matmul(x, a, planes, 4,
                                        tensor_cores=tensor_cores)
        torch.cuda.synchronize()
        assert torch.equal(y, want)
        assert torch.equal(y, bitplane_matmul_ref(q.exp, q.sign, w, 4))


MAMBA_GRAPH = dict(max_slots=2, max_len=64, buckets=(8, 16), tick_steps=3,
                   paged=True, page_len=8, prefix_cache=True,
                   chunked="auto", chunk_len=8)


def _mamba_prompts(vocab):
    """Page-aligned prefix owners (16 tokens bucketed, 24 chunked) and
    prompts that hit their snapshots."""
    import numpy as np

    rng = np.random.default_rng(4)

    def tok(n):
        return rng.integers(0, vocab, size=n).astype(np.int32)

    a, b = tok(16), tok(24)
    return [a, b, np.concatenate([a, tok(5)]), tok(30),
            np.concatenate([b, tok(3)]), np.concatenate([a, tok(9)])]


@pytest.mark.parametrize("quant", [False, True])
def test_mamba_graph_tick_bit_equal_to_eager(cuda, quant):
    """The mamba smoke config's scheduler programs as CUDA graphs against
    ``engine.eager()`` (bf16, packed planes with stats when quantized):
    tokens, stats, and after every tick the lengths, page tables, SSM/conv
    state and pool bytes equal bit for bit; snapshot hits served."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

    cfg = get_smoke("mamba2-780m")
    params = init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    kw = dict(MAMBA_GRAPH)
    if quant:
        params = quantize_model_params(cfg, params, pack=True)
        kw.update(quant="pallas", with_stats=True)
    prompts = _mamba_prompts(cfg.vocab_size)
    with engine.eager():
        _, elog, eres = _serve_ticks(cfg, params, kw, prompts)
    sched, glog, gres = _serve_ticks(cfg, params, kw, prompts)
    assert gres == eres
    assert len(glog) == len(elog)
    for t, (g, e) in enumerate(zip(glog, elog)):
        assert torch.equal(g[0], e[0]), f"lengths, tick {t}"
        assert np.array_equal(g[1], e[1]), f"table, tick {t}"
        for a, b in zip(g[2], e[2]):
            assert torch.equal(a, b), f"pool bytes, tick {t}"
    assert sched.prefix_cache_stats()["lookup_hits"] >= 1
    for name, prog in sched.programs().items():
        for entry in prog.entries():
            assert entry.graph is not None
            assert entry.replays == entry.calls >= 1, name
    tick = sched.programs()["tick"].entries()[0].census
    assert tick["bitplane_matmul"] == (cfg.n_layers * 3 * 3 if quant else 0)
    assert tick["paged_attention"] == tick["paged_attention_quant"] == 0


def test_mamba_generate_program_bit_equal_to_eager(cuda):
    """The mamba one-shot program on packed planes with stats: eager, then
    two graph calls, equal tokens and stats; K2 launches 3 per layer per
    forward by the capture census."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

    cfg = get_smoke("mamba2-780m")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = quantize_model_params(cfg, init_params(
        cfg, generator=gen, device=cuda), pack=True)
    prompt = torch.randint(0, cfg.vocab_size, (3, 9), generator=gen,
                           device=cuda, dtype=torch.int32)
    runs = []
    for mode in ("eager", "graph", "graph"):
        with engine.eager() if mode == "eager" else torch.no_grad():
            runs.append(engine.greedy_generate(cfg, params, prompt, 8,
                                               quant=True, with_stats=True))
    for toks, st in runs[1:]:
        assert torch.equal(toks, runs[0][0])
        for key in st:
            assert torch.equal(st[key], runs[0][1][key])
    (entry,) = engine.generate_fn(cfg, params, 8, 0.0, True, None, True,
                                  cuda).program.entries()
    assert entry.census["bitplane_matmul"] == cfg.n_layers * 3 * 8


def test_capture_survives_a_dead_program_in_a_cycle(cuda):
    """A program whose graph sits in a dead reference cycle (a discarded
    scheduler's programs are bound methods of it) must not be destroyed
    by the cyclic collector while another program captures: a graph
    destroyed mid-capture invalidates the capture.  The body collects
    only while its stream captures, which is when the collector would
    find the cycle if the capture had not collected it first."""
    import gc

    from repro_torch.serving import engine

    x = torch.arange(4.0, device=cuda)
    dead = engine.Program(lambda t: (t + 1,), name="dead", device=cuda)
    dead(x)
    dead.cycle = dead
    del dead

    def body(t):
        if torch.cuda.is_current_stream_capturing():
            gc.collect()
        return (t * 2,)

    live = engine.Program(body, name="live", device=cuda)
    assert torch.equal(live(x)[0], x * 2)
    assert torch.equal(live(x + 1)[0], (x + 1) * 2)
    assert live.entries()[0].replays == 2


# ---------------------------------------------------------------------------
# the MoE smoke config's serving programs as CUDA graphs
# ---------------------------------------------------------------------------

def test_moe_graph_tick_bit_equal_to_eager_and_to_itself(cuda):
    """deepseek-moe smoke (8 experts top-3, 2 shared) quantized with
    stats, paged with the prefix cache and K3: the scheduler's graphs
    against ``engine.eager()`` and a second graph run, over a trace whose
    ticks overflow expert capacity (3 slots x 3 slots over 8 experts
    admit 2 a expert): tokens, per-request stats, and after every tick
    the lengths, page tables and pool bytes equal bit for bit.  The
    combine is an ordered sum (no atomics), so nothing moves between
    runs.  Then the one-shot program: eager, graph, graph equal."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

    cfg = get_smoke("deepseek-moe-16b")
    params = quantize_model_params(cfg, init_params(
        cfg, generator=torch.Generator(device=cuda).manual_seed(0),
        device=cuda), pack=True)
    kw = dict(GRAPH_PAGED, quant="pallas", with_stats=True)
    prompts = _graph_prompts(cfg.vocab_size)
    tables, dropped = moe._dispatch_tables, []

    def counting(ids, n_experts, capacity):
        order, dest, keep = tables(ids, n_experts, capacity)
        dropped.append(int((~keep).sum()))
        return order, dest, keep

    moe._dispatch_tables = counting
    try:
        with engine.eager():
            _, elog, eres = _serve_ticks(cfg, params, kw, prompts)
    finally:
        moe._dispatch_tables = tables
    assert sum(dropped) > 0
    runs = [_serve_ticks(cfg, params, kw, prompts) for _ in range(2)]
    for sched, glog, gres in runs:
        assert gres == eres
        assert len(glog) == len(elog)
        for t, (g, e) in enumerate(zip(glog, elog)):
            assert torch.equal(g[0], e[0]), f"lengths, tick {t}"
            assert np.array_equal(g[1], e[1]), f"table, tick {t}"
            for a, b in zip(g[2], e[2]):
                assert torch.equal(a, b), f"pool bytes, tick {t}"
        for name, prog in sched.programs().items():
            for entry in prog.entries():
                assert entry.graph is not None
                assert entry.replays == entry.calls >= 1, name
        tick = sched.programs()["tick"].entries()[0].census
        assert tick["bitplane_matmul"] == cfg.n_layers * 7 * 4
        assert tick["paged_attention"] == cfg.n_layers * 4

    gen = torch.Generator(device=cuda).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 9), generator=gen,
                           device=cuda, dtype=torch.int32)
    outs = []
    for mode in ("eager", "graph", "graph"):
        with engine.eager() if mode == "eager" else torch.no_grad():
            outs.append(engine.greedy_generate(cfg, params, prompt, 8,
                                               quant=True, with_stats=True))
    for toks, st in outs[1:]:
        assert torch.equal(toks, outs[0][0])
        for key in st:
            assert torch.equal(st[key], outs[0][1][key])


# ---------------------------------------------------------------------------
# qwen3-32b: K2 at its largest projection shapes, its serving programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("k,n", [(25600, 5120), (5120, 25600)])
def test_fused_kernel_bit_equal_at_qwen3_shapes(cuda, k, n, layout):
    """``down`` (K 25600: 200 K tiles over the cluster ranks) and
    ``gate``/``up`` (N 25600) at a decode step's M = 4: output equal to
    the plain version and the direct-shift oracle, codes to K1's."""
    x, w, unpacked, packed = _fused(4, k, n, k + n, torch.bfloat16)
    planes = packed if layout == "packed" else unpacked
    a = torch.tensor(0.37, device=cuda)
    want, q = bm_ops.log2_bitplane_matmul_plain(x, a, planes, 4)
    y, got = bm_ops.log2_bitplane_matmul(x, a, planes, 4, codes=True)
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    assert torch.equal(got.exp, q.exp) and torch.equal(got.sign, q.sign)
    assert torch.equal(y, bitplane_matmul_ref(q.exp, q.sign, w, 4))


def test_qwen3_graph_tick_and_generate_bit_equal_to_eager(cuda):
    """qwen3 smoke (``qk_norm``) on packed planes with stats, paged with
    the prefix cache and K3: the scheduler's graphs against
    ``engine.eager()`` (tokens, stats, and after every tick the lengths,
    page tables and pool bytes bit for bit), then the one-shot program:
    eager, graph, graph equal."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params
    from repro_torch.serving import engine

    cfg = get_smoke("qwen3-32b")
    params = quantize_model_params(cfg, init_params(
        cfg, generator=torch.Generator(device=cuda).manual_seed(0),
        device=cuda), pack=True, drop_float=True)
    kw = dict(GRAPH_PAGED, quant="pallas", with_stats=True)
    prompts = _graph_prompts(cfg.vocab_size)
    with engine.eager():
        _, elog, eres = _serve_ticks(cfg, params, kw, prompts)
    sched, glog, gres = _serve_ticks(cfg, params, kw, prompts)
    assert gres == eres
    assert len(glog) == len(elog)
    for t, (g, e) in enumerate(zip(glog, elog)):
        assert torch.equal(g[0], e[0]), f"lengths, tick {t}"
        assert np.array_equal(g[1], e[1]), f"table, tick {t}"
        for a, b in zip(g[2], e[2]):
            assert torch.equal(a, b), f"pool bytes, tick {t}"
    tick = sched.programs()["tick"].entries()[0].census
    assert tick["bitplane_matmul"] == cfg.n_layers * 7 * 4
    assert tick["paged_attention"] == cfg.n_layers * 4

    gen = torch.Generator(device=cuda).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 9), generator=gen,
                           device=cuda, dtype=torch.int32)
    outs = []
    for mode in ("eager", "graph", "graph"):
        with engine.eager() if mode == "eager" else torch.no_grad():
            outs.append(engine.greedy_generate(cfg, params, prompt, 8,
                                               quant=True, with_stats=True))
    for toks, st in outs[1:]:
        assert torch.equal(toks, outs[0][0])
        for key in st:
            assert torch.equal(st[key], outs[0][1][key])


# ---------------------------------------------------------------------------
# the paper's evaluation: K1 on the paper nets' recorded GEMM inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["alexnet", "ptblm", "encoder-relu",
                                 "encoder-gelu"])
def test_paper_net_codes_bit_equal_to_plain(cuda, net):
    """The nets narrow on the card (AlexNet at its fixed size): one K1
    launch for all recorded tensors, its codes bit-equal to the plain
    version and to one launch per tensor on the same activations;
    ``measure`` of the flat codes equal to ``measure`` of the per-tensor
    codes concatenated, on the card and on the host."""
    from repro_torch.models import paper_nets
    from repro_torch.simulator import measure

    gen = torch.Generator(device=cuda).manual_seed(7)
    if net == "alexnet":
        acts = paper_nets.alexnet_activations(
            paper_nets.init_paper_params("alexnet", gen, cuda))
    elif net == "ptblm":
        acts = paper_nets.ptblm_activations(paper_nets.init_paper_params(
            "ptblm", gen, cuda, seq=4, hidden=32))
    else:
        acts = paper_nets._encoder_activations(
            paper_nets._encoder_params(gen, cuda, 2, 128, 256, 8),
            net.split("-")[1])
    before = l2_ops.log2quant.launches
    flat, views = l2_ops.log2quant_many([a for _, a in acts])
    torch.cuda.synchronize()
    assert l2_ops.log2quant.launches == before + 1
    codes = [l2_ops.log2quant(a) for _, a in acts]
    for (name, a), v, q in zip(acts, views, codes):
        assert a.is_cuda and a.dtype == torch.float32, name
        ref = log2_quantize(a)
        for got in (v, q):
            assert torch.equal(got.exp, ref.exp), name
            assert torch.equal(got.sign, ref.sign), name
    exp = torch.cat([q.exp.reshape(-1) for q in codes])
    card = measure(LogQuantized(flat.exp, torch.ones_like(flat.exp)))
    for other in (exp, exp.cpu()):
        st = measure(LogQuantized(other, torch.ones_like(other)))
        assert (card.hist == st.hist).all()
        assert card.zero_frac == st.zero_frac


# ---------------------------------------------------------------------------
# disaggregated serving: spans imported into captured graphs
# ---------------------------------------------------------------------------

DISAGG = dict(max_slots=2, max_len=48, buckets=(8, 16), tick_steps=2,
              paged=True, page_len=8, chunked="auto", chunk_len=8,
              attn_kernel="pallas", attn_splits=2)
DISAGG_MODES = {
    "float_k3": ("smollm-135m", DISAGG, False),
    "packed_kv_quant_k4": ("smollm-135m", dict(
        DISAGG, kv_quant=True, kv_bits=4, quant="pallas", with_stats=True),
        True),
    "mamba_prefix": ("mamba2-780m", dict(DISAGG, prefix_cache=True), False),
}


def _disagg_model(cuda, arch, quant):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import init_params
    from repro_torch.models.quantize import quantize_model_params

    cfg = get_smoke(arch)
    params = init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    if quant:
        params = quantize_model_params(cfg, params, pack=True)
    return cfg, params


def _served(sched, prompts):
    for p in prompts:
        sched.submit(p, max_new=6)
    return [(r.tokens, r.finish_reason, repr(r.plane_traffic_fraction),
             r.admitted_tick) for r in sched.run()]


@pytest.mark.parametrize("mode", list(DISAGG_MODES))
def test_span_import_into_captured_graphs_equals_eager(cuda, mode):
    """The router on the card (bf16 smoke config): spans imported into a
    decode pool whose tick graph was captured before (admitted on a later
    decode tick) replay to the tokens, stats and admission ticks of the
    same run under ``engine.eager()``, and to the combined scheduler's
    tokens; no program raised for moved memory, every program that ran
    was captured once and replayed on every later call."""
    from repro_torch.serving import Router, ServeConfig, ServeScheduler
    from repro_torch.serving import engine

    arch, kw, quant = DISAGG_MODES[mode]
    cfg, params = _disagg_model(cuda, arch, quant)
    prompts = _graph_prompts(cfg.vocab_size)
    with engine.eager():
        eager = _served(Router(cfg, params, ServeConfig(**kw), device=cuda),
                        prompts)
    router = Router(cfg, params, ServeConfig(**kw), device=cuda)
    graph = _served(router, prompts)
    combined = _served(ServeScheduler(cfg, params, ServeConfig(**kw),
                                      device=cuda), prompts)
    assert graph == eager
    assert [r[0] for r in graph] == [r[0] for r in combined]
    assert any(r[3] > 0 for r in graph)     # imported after the capture
    for eng in (router.prefill, router.decode):
        for name, prog in eng.scheduler.programs().items():
            for entry in prog.entries():
                assert entry.graph is not None
                assert entry.replays == entry.calls >= 1, name
    (tick,) = router.decode.scheduler.programs()["tick"].entries()
    assert tick.replays > 1


def test_bf16_span_survives_a_frame_round_trip(cuda):
    """A bf16 kv_quant span exported from the card's pool, written to a
    frame (dtype ``"bfloat16"`` on the wire) and read back, holds the
    exported arrays bit for bit, writes the same frame again, and lands
    in a decode pool on the card bit for bit."""
    import json

    from repro_torch.serving import (DecodeEngine, PageSpan, PrefillEngine,
                                     ServeConfig)
    from repro_torch.serving.workers import BF16Bits

    kw = dict(DISAGG, kv_quant=True, kv_bits=4)
    cfg, params = _disagg_model(cuda, "smollm-135m", False)
    prompt = _graph_prompts(cfg.vocab_size)[2]          # 21 tokens: chunked
    span, _ = PrefillEngine(cfg, params, ServeConfig(**kw),
                            device=cuda).prefill(prompt, max_new=6)
    blob = span.to_bytes()
    back = PageSpan.from_bytes(blob)
    assert back.to_bytes() == blob
    hdr_len = int.from_bytes(blob[10:14], "little")
    dtypes = {d["name"]: d["dtype"]
              for d in json.loads(blob[14:14 + hdr_len])["arrays"]}
    assert dtypes["logits"] == dtypes["layer0.k_tail"] == "bfloat16"
    assert isinstance(back.logits, BF16Bits)

    def bits(t):
        return t.view(torch.int16).cpu()

    for k, a in span.layers[0].items():
        assert type(back.layers[0][k]) is type(a), k
        assert a.dtype == back.layers[0][k].dtype, k
        assert (back.layers[0][k] == a).all(), k
    assert (back.logits == span.logits).all()
    dec = DecodeEngine(cfg, params, ServeConfig(**kw), device=cuda)
    assert dec.admit(back, rid=0) == "ok"
    d = dec.scheduler
    mine = torch.as_tensor(d._table[0, :span.n_blocks].astype("int64"),
                           device=cuda)
    layer = d._pool["layers"][0]
    for k in ("k_tail", "v_tail"):
        want = torch.from_numpy(back.layers[0][k].view("int16"))
        assert torch.equal(bits(layer[k][:, 0]), want), k
    for k in ("k_codes", "v_codes", "k_scale", "v_scale"):
        assert torch.equal(layer[k].index_select(1, mine).cpu(),
                           torch.from_numpy(back.layers[0][k])), k
    assert torch.equal(bits(d._logits[0]),
                       torch.from_numpy(back.logits.view("int16")))
    assert dec.step()


# ---------------------------------------------------------------------------
# training: a smoke train step and the flash Function on the card
# ---------------------------------------------------------------------------

def _train_batch(cfg, seed, b=2, s=16):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                    dtype=torch.int32),
            "labels": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                    dtype=torch.int32),
            "mask": (torch.rand((b, s), generator=g) < 0.8).float()}


@pytest.mark.parametrize("name", ["smollm_135m", "mamba2_780m",
                                  "deepseek_moe_16b"])
def test_train_step_on_card_matches_host(cuda, name):
    """One f32 smoke train step (2 micro-batches, AdamW) on the card
    against the host: loss within 1e-5 relative, every gradient leaf within
    1e-4 of its largest magnitude, and the stepped params within 0.05 lr
    (AdamW normalises each element's step)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.trainer import make_loss_fn, value_and_grad
    from repro_torch.tree import flatten_with_path, tree_map

    cfg = get_smoke(name).replace(dtype=torch.float32)
    host = init_params(cfg, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    batch = _train_batch(cfg, 4)
    cbatch = {k: v.to(cuda) for k, v in batch.items()}
    lh, gh = value_and_grad(make_loss_fn(cfg), host, batch)
    lc, gc = value_and_grad(make_loss_fn(cfg), card, cbatch)
    assert abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh))
    for (key, a), (_, b) in zip(flatten_with_path(gh), flatten_with_path(gc)):
        b = b.cpu()
        assert bool(torch.isfinite(b).all()), key
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max()), key
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1),
                       micro_batches=2)
    ph, _, mh = make_train_step(cfg, tcfg)(host, adamw.init(host), batch)
    pc, _, mc = make_train_step(cfg, tcfg)(card, adamw.init(card), cbatch)
    assert abs(float(mc["loss"]) - float(mh["loss"])) <= 1e-5 * float(
        mh["loss"])
    for (key, a), (_, b) in zip(flatten_with_path(ph), flatten_with_path(pc)):
        assert float((a - b.cpu()).abs().max()) <= 0.05 * 1e-3, key


@pytest.mark.parametrize("chunk", [64, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_matches_autograd_on_card(cuda, dtype, chunk):
    """The flash Function's output and dq, dk, dv against torch autograd
    through the plain chunked forward (f32 within 2e-5 of each tensor's
    largest magnitude; bf16 within twice plain autograd's distance from
    the f32 gradients, or 2^-7), and no saved tensor of a chunk's score
    shape.  B 2, S 64, 6/2 heads x 32; ``kv_chunk`` 64 and 24 (a padded
    last chunk)."""
    from repro_torch.models import attention

    b, s, h, g, d = 2, 64, 6, 2, 32
    gen = torch.Generator(device=cuda).manual_seed(chunk)
    base = [torch.randn(shape, generator=gen, device=cuda)
            for shape in ((b, s, h, d), (b, s, g, d), (b, s, g, d),
                          (b, s, h, d))]
    pos = torch.arange(s, device=cuda, dtype=torch.int32).expand(b, s)

    def run(fn, q, k, v, do, saved=None):
        ts = [t.detach().requires_grad_() for t in (q, k, v)]

        def pack(t):
            if saved is not None:
                saved.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn(*ts)
            grads = torch.autograd.grad(out, ts, do)
        return [out.detach()] + list(grads)

    def rel(x, y):
        return float((x.float() - y.float()).abs().max()
                     / y.float().abs().max())

    def plain(q, k, v):
        return attention.flash_forward(q, k, v, pos, pos, True, chunk)[0]

    q, k, v, do = (t.to(dtype) for t in base)
    saved = []
    got = run(lambda q_, k_, v_: attention.flash_attention(
        q_, k_, v_, pos, pos, kv_chunk=chunk), q, k, v, do, saved)
    want = run(plain, q, k, v, do)
    assert saved and not [sh for sh in saved if sh[-2:] == (s, chunk)]
    if dtype == torch.float32:
        assert max(rel(x, y) for x, y in zip(got, want)) <= 2e-5
    else:
        f32 = run(plain, *(t.float() for t in (q, k, v, do)))
        for x, y, r in zip(got, want, f32):
            assert rel(x, r) <= max(2 * rel(y, r), 2 ** -7)
