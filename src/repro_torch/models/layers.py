"""Shared layer primitives (port of ``src/repro/models/layers.py``):
RMSNorm, rotary embeddings, the float-or-quantized projection, SwiGLU."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.shiftadd import (QuantCtx, QuantizedLinearParams,
                                       as_quant_ctx, quantized_linear_apply)
from repro_torch.models import sharding


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].float() * freqs             # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense(w: torch.Tensor, x: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          quant: Optional[QuantizedLinearParams] = None,
          ctx=None, reduce: bool = False) -> torch.Tensor:
    """``w``: (K, N); ``x``: (..., K); ``bias`` (N,) is added after the
    cast to ``x.dtype``.  With ``quant`` the GEMM runs through the
    LOG2-activation / bit-plane-weight shift-add path; ``ctx`` (bool |
    QuantCtx) carries its bit width and optional traffic collection.  A
    float projection whose weight ``quantize_model_params(...,
    drop_float=True)`` dropped raises.

    ``reduce=True`` makes it row-parallel on the model axis
    (``models.sharding``): ``w`` (or the planes) and ``x`` hold a rank's
    run of K, and the partial products are summed over the ranks before
    the bias, as int32 on the quantized path (before its float epilogue),
    in f32 otherwise: each partial an f32 product of the ``x.dtype``
    operands, their sum rounded to ``x.dtype`` once, as one card's GEMM
    rounds its f32 accumulator once."""
    if quant is not None:
        qc = as_quant_ctx(ctx) or QuantCtx()
        y = quantized_linear_apply(quant, x, n_bits=qc.n_bits, ctx=qc,
                                   reduce=reduce).to(x.dtype)
    elif w.dim() < 2:
        raise ValueError(f"float projection of a dropped weight {tuple(w.shape)}"
                         f" (drop_float keeps only the planes): run it "
                         f"quantized")
    elif reduce:
        part = torch.matmul(x.float(), w.to(x.dtype).float())
        y = sharding.all_reduce(part).to(x.dtype)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def swiglu(p, x: torch.Tensor, quant=False,
           ff: Optional[int] = None) -> torch.Tensor:
    """p: {'gate': (d, ff), 'up': (d, ff), 'down': (ff, d)} (+ ``*_q``).

    On a model axis ``gate``/``up`` may hold a rank's run of the ``ff``
    columns (column-parallel) and ``down`` the matching rows, which makes
    ``down`` row-parallel: the ranks' partials are summed (``dense(...,
    reduce=True)``).  ``ff`` is the full width that tells them apart."""
    g = dense(p["gate"], x, quant=p.get("gate_q") if quant else None,
              ctx=quant)
    u = dense(p["up"], x, quant=p.get("up_q") if quant else None, ctx=quant)
    h = F.silu(g.float()).to(x.dtype) * u
    return dense(p["down"], h, quant=p.get("down_q") if quant else None,
                 ctx=quant, reduce=ff is not None and sharding.cut_of(
                     ff, g.shape[-1], "swiglu ff columns") > 1)
