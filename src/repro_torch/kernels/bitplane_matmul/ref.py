"""Plain-PyTorch oracle for the bit-plane GEMM: direct per-element shifts.

The literal transcription of paper Eq. 5 with the D&S unit's arithmetic
shift — no bit-plane regrouping, no tiling — so kernel and oracle share
neither algorithm nor layout (port of
``src/repro/kernels/bitplane_matmul/ref.py``).  Rows go through in slices
to bound the ``(rows, K, N)`` temporaries.
"""

from __future__ import annotations

import torch


def bitplane_matmul_ref(exp: torch.Tensor, sign: torch.Tensor,
                        w_int8: torch.Tensor, n_bits: int = 4,
                        rows_per_slice: int = 16) -> torch.Tensor:
    """exp/sign: (M, K) int8; w_int8: (K, N) int8 -> (M, N) int32."""
    sentinel = -(1 << (n_bits - 1))
    w = w_int8.to(torch.int32)[None]                   # (1, K, N)
    outs = []
    for i in range(0, exp.shape[0], rows_per_slice):
        e = exp[i:i + rows_per_slice].to(torch.int32)[:, :, None]
        s = sign[i:i + rows_per_slice].to(torch.int32)[:, :, None]
        left = w << torch.clamp(e, min=0)
        right = w >> torch.clamp(-e, min=0)            # floor(w / 2^|e|)
        prod = torch.where(e >= 0, left, right)
        prod = torch.where(e == sentinel, 0, prod)
        outs.append((s * prod).sum(dim=1, dtype=torch.int32))
    if not outs:
        return torch.zeros((0, w_int8.shape[1]), dtype=torch.int32,
                           device=w_int8.device)
    return torch.cat(outs)
