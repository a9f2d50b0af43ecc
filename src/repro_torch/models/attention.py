"""GQA attention: flash-style chunked prefill and KV-cache decode (forward
only; port of the dense branches of ``src/repro/models/attention.py``).

Queries reshape to (B, S, G, R, D) with G = kv heads and R = group size,
so K/V are never repeated.  Scores and the PV product accumulate in
float32 (bf16 inputs widen exactly); ``p`` is cast to the V dtype before
PV, masked scores take the finite ``NEG_INF``, as in the reference.

The dense ``KVCache`` is updated in place: prefill writes the fresh K/V at
``length`` and attends over them, decode writes one row and attends over
the cache.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import apply_rope, dense

NEG_INF = -1e30


def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    causal: bool = True, kv_chunk: int = 1024,
                    kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, G, D).  Returns (B, Sq, H, D).

    Online softmax over KV chunks of ``min(kv_chunk, Skv)`` keys, the same
    chunking as the reference, so the float sums group the same way.
    """
    b, sq, h, d = q.shape
    if sq == 1:
        return _decode_attention(q, k, v, q_positions, kv_positions,
                                 kv_valid_len)
    skv, g = k.shape[1], k.shape[2]
    r = h // g
    chunk = min(kv_chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=2 ** 30)
    scale = 1.0 / math.sqrt(d)
    qg = _grouped(q, g).float()
    m = torch.full((b, g, r, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, g, r, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, g, r, sq, d), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        kb, vb, pb = k[:, sl], v[:, sl], kv_positions[:, sl]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb.float()) * scale
        mask = torch.ones((b, 1, 1, sq, chunk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = (pb[:, None, None, None, :]
                    <= q_positions[:, None, None, :, None])
        if kv_valid_len is not None:
            idx = ci * chunk + torch.arange(chunk, device=q.device)
            mask = mask & (idx[None, None, None, None, :]
                           < kv_valid_len[:, None, None, None, None])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(q.dtype).float(),
                          vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out_g = acc / torch.clamp(l[..., None], min=1e-30)      # (B,G,R,Sq,D)
    return out_g.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _decode_attention(q, k, v, q_positions, kv_positions, kv_valid_len):
    """q: (B, 1, H, D) against the whole cache — one masked product."""
    b, _, h, d = q.shape
    g = k.shape[2]
    qg = _grouped(q, g)[:, 0].float()                     # (B, G, R, D)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k.float()) / math.sqrt(d)
    mask = kv_positions[:, None, None, :] <= q_positions[:, None, None, :1]
    if kv_valid_len is not None:
        idx = torch.arange(k.shape[1], device=q.device)
        mask = mask & (idx[None, None, None, :]
                       < kv_valid_len[:, None, None, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p.to(q.dtype).float(), v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor           # (B, S_max, G, D)
    v: torch.Tensor
    length: int               # tokens currently valid (whole batch)


def attention(p, x: torch.Tensor, positions: torch.Tensor, cfg,
              cache: Optional[KVCache] = None, quant=False):
    """GQA block body (pre-norm residual handled by the caller).

    Returns ``(attn_out, new_cache)``.  With ``cache``, ``x`` is appended
    at ``cache.length``: a prompt (the cache assumed empty before; attend
    over the fresh K/V) or one decode token (attend over the cache).
    """
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(p["wq"], x, p.get("wq_q") if quant else None, ctx=quant)
    k = dense(p["wk"], x, p.get("wk_q") if quant else None, ctx=quant)
    v = dense(p["wv"], x, p.get("wv_q") if quant else None, ctx=quant)
    q = apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, s, hkv, hd)

    if cache is None:
        out = flash_attention(q, k, v, positions, positions, causal=True,
                              kv_chunk=cfg.kv_chunk)
        new_cache = None
    else:
        idx = cache.length
        if idx + s > cache.k.shape[1]:
            raise ValueError(f"cache of {cache.k.shape[1]} rows cannot take "
                             f"{s} tokens at {idx}")
        cache.k[:, idx:idx + s] = k.to(cache.k.dtype)
        cache.v[:, idx:idx + s] = v.to(cache.v.dtype)
        new_len = idx + s
        if s == 1:
            kv_pos = torch.arange(cache.k.shape[1], dtype=torch.int32,
                                  device=x.device).expand(b, -1)
            valid = torch.full((b,), new_len, dtype=torch.int32,
                               device=x.device)
            out = flash_attention(q, cache.k, cache.v, positions, kv_pos,
                                  causal=True, kv_chunk=cfg.kv_chunk,
                                  kv_valid_len=valid)
        else:
            out = flash_attention(q, k, v, positions, positions, causal=True,
                                  kv_chunk=cfg.kv_chunk)
        new_cache = KVCache(k=cache.k, v=cache.v, length=new_len)

    out = out.reshape(b, s, h * hd)
    y = dense(p["wo"], out, p.get("wo_q") if quant else None, ctx=quant)
    return y, new_cache
