"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU.  The file imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from repro_torch.core.bitplane import to_bitplanes
from repro_torch.core.logquant import LogQuantized, log2_quantize
from repro_torch.core.shiftadd import shiftadd_matmul_bitplane
from repro_torch.core.wquant import quantize_weights
from repro_torch.kernels.bitplane_matmul import ops as bm_ops
from repro_torch.kernels.bitplane_matmul.ref import bitplane_matmul_ref
from repro_torch.kernels.log2quant import ops as l2_ops

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
