"""Dense-gather oracles for the paged-attention decode kernels (port of
``src/repro/kernels/paged_attention/ref.py``).

Op for op the scheduler's dense path specialised to decode: gather every
page the table names into the padded logical view, run ONE masked einsum
and a monolithic softmax over it.  Decode queries sit at position
``lengths - 1``, so the causal and the validity mask are the same set and
the single ``kv_pos < lengths`` mask is carried.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.logquant import dequantize_page_codes

NEG_INF = -1e30


def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, D); k/v pool (P, page_len, G, D); page_table (B, NB)
    int32; lengths (B,) int32 valid tokens per row.  Returns (B, 1, H, D).
    """
    b, _, h, d = q.shape
    page_len, g = k_pool.shape[1], k_pool.shape[2]
    nb = page_table.shape[1]
    table = page_table.long()
    kg = k_pool[table].reshape(b, nb * page_len, g, d)
    vg = v_pool[table].reshape(b, nb * page_len, g, d)
    qg = q.reshape(b, g, h // g, d)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(), kg.float())
    s = s / math.sqrt(d)
    idx = torch.arange(nb * page_len, device=q.device)
    mask = idx[None, None, None, :] < lengths.long()[:, None, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p.to(q.dtype).float(), vg.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_attention_quant_reference(q: torch.Tensor, k_codes: torch.Tensor,
                                    k_scale: torch.Tensor,
                                    v_codes: torch.Tensor,
                                    v_scale: torch.Tensor,
                                    page_table: torch.Tensor,
                                    lengths: torch.Tensor,
                                    n_bits: int = 4) -> torch.Tensor:
    """The quantized kernel's oracle: dequantize both code pools under
    their (P, G) scales, then :func:`paged_attention_reference` with ``q``
    widened to f32 (the kernel keeps ``p`` in f32).  Returns (B, 1, H, D)
    in q's dtype."""
    k = dequantize_page_codes(k_codes, k_scale[:, None, :, None], n_bits)
    v = dequantize_page_codes(v_codes, v_scale[:, None, :, None], n_bits)
    return paged_attention_reference(q.float(), k, v, page_table,
                                     lengths).to(q.dtype)
