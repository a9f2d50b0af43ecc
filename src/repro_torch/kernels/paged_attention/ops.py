"""Wrapper for the CUDA paged-attention decode kernel
(``csrc/paged_attention.cu``), its plain PyTorch version, the split merge
and the page-traffic accounting (port of ``src/repro/kernels/
paged_attention/ops.py`` and of ``make_page_table`` / ``RAGGED512`` from its
``kernel.py``).

``paged_attention(qg, k_pool, v_pool, page_table, lengths, splits)``
returns the unnormalised split partials ``(o, m, l)``.  A CUDA tensor
launches the kernel on the current stream (or raises); a CPU tensor runs
:func:`paged_attention_plain`.  ``paged_attention.launches`` counts kernel
launches.  :func:`paged_decode_attention` is the model's entry: grouped
reshape, trash-column padding of the table to a multiple of ``splits``,
the partials, :func:`merge_split_softmax`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NEG_INF = -1e30

_KINDS = {torch.float32: 0, torch.bfloat16: 1}

# The long-context ragged decode tick of the reference's kernel bench and
# static verifier: touched/total pages = 57/128
RAGGED512 = dict(b=4, page_len=16, nb=32, g=2, r=2, d=16,
                 lengths=(512, 300, 64, 17))


def make_page_table(lengths, nb: int, page_len: int) -> np.ndarray:
    """The canonical page table of a decode tick: each slot's pages are
    allocated sequentially from page 1 (page 0 is the trash page), columns
    past ``ceil(length / page_len)`` stay trash."""
    lens = np.asarray(lengths, np.int32)
    table = np.zeros((len(lens), nb), np.int32)
    nxt = 1
    for i, ln in enumerate(lens):
        for j in range(-(-int(ln) // page_len)):
            table[i, j] = nxt
            nxt += 1
    return table


def _lib():
    lib = _build.library("paged_attention")
    if lib.qh_paged_attention.argtypes is None:
        lib.qh_paged_attention.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.qh_paged_attention.restype = ctypes.c_int
        lib.qh_paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.qh_paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention_plain(qg: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, splits: int = 1):
    """The kernel's function in plain PyTorch: each split walks its pages
    in order with the online-softmax recurrence of the reference's
    ``_paged_attn_kernel`` (f32 statistics, ``p`` cast to the V dtype
    before PV), all (slot, head, split) cells at once.  A page wholly past
    a row's length leaves that row's state untouched, as the kernel, which
    does not load it, does."""
    b, g, r, d = qg.shape
    page_len = k_pool.shape[1]
    nb = page_table.shape[1]
    bps = nb // splits
    dev = qg.device
    table = page_table.long().reshape(b, splits, bps)
    lens = lengths.long()
    q = qg.float()
    scale = math.sqrt(d)          # a host scalar: graph-capturable
    m = torch.full((b, g, splits, r), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, g, splits, r), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, g, splits, r, d), dtype=torch.float32, device=dev)
    split_base = torch.arange(splits, device=dev) * bps
    offs = torch.arange(page_len, device=dev)
    for j in range(bps):
        kb = k_pool[table[:, :, j]].float()          # (B, S, pl, G, D)
        vb = v_pool[table[:, :, j]]
        s = torch.einsum("bgrd,bstgd->bgsrt", q, kb) / scale
        start = (split_base + j) * page_len          # (S,)
        pos = start[:, None] + offs                  # (S, pl)
        valid = pos[None] < lens[:, None, None]      # (B, S, pl)
        s = torch.where(valid[:, None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bgsrt,bstgd->bgsrd", p.to(vb.dtype).float(),
                          vb.float())
        acc_new = acc * corr[..., None] + pv
        live = (start[None] < lens[:, None])[:, None, :, None]  # (B,1,S,1)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    return acc, m, l


def paged_attention(qg: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, splits: int = 1):
    """qg (B, G, R, D); k/v pool (P, page_len, G, D); page_table (B, NB)
    int32 with NB a multiple of ``splits``; lengths (B,) int32.  Returns
    ``(o, m, l)``: o (B, G, splits, R, D) f32, m/l (B, G, splits, R) f32 —
    merge with :func:`merge_split_softmax`."""
    if qg.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"qg must be (B, G, R, D) and the pools one (P, "
                         f"page_len, G, D) shape, got {tuple(qg.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, g, r, d = qg.shape
    n_pages, page_len, gk, dk = k_pool.shape
    if (gk, dk) != (g, d):
        raise ValueError(f"pool heads/dim {(gk, dk)} != query's {(g, d)}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"page_table must be (B={b}, NB) and lengths "
                         f"(B,), got {tuple(page_table.shape)} and "
                         f"{tuple(lengths.shape)}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    nb = page_table.shape[1]
    if splits < 1 or nb % splits:
        raise ValueError(f"NB={nb} must be a positive multiple of "
                         f"splits={splits}")
    if not (qg.device == k_pool.device == v_pool.device == page_table.device
            == lengths.device):
        raise ValueError("all operands must share one device")
    if qg.device.type == "cpu":
        return paged_attention_plain(qg, k_pool, v_pool, page_table, lengths,
                                     splits)
    if qg.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU, not "
                         f"{qg.device}")
    if qg.dtype not in _KINDS or not qg.dtype == k_pool.dtype == v_pool.dtype:
        raise TypeError(f"q and the pools must share one dtype, f32 or "
                        f"bf16, got {qg.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if not all(t.is_contiguous() for t in (qg, k_pool, v_pool, page_table,
                                           lengths)):
        raise ValueError("paged_attention needs contiguous inputs")
    dev = qg.device
    o = torch.empty((b, g, splits, r, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, g, splits, r), dtype=torch.float32, device=dev)
    l = torch.empty((b, g, splits, r), dtype=torch.float32, device=dev)
    if b and g and r:
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qh_paged_attention(
            qg.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, g, r, d, page_len, nb, splits,
            n_pages, _KINDS[qg.dtype], stream)
        if rc != 0:
            raise RuntimeError(
                "paged_attention launch failed: "
                + lib.qh_paged_attention_error_string(rc).decode())
        paged_attention.launches += 1
    return o, m, l


paged_attention.launches = 0


def merge_split_softmax(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                        axis: int = -1) -> torch.Tensor:
    """Reduce per-split online-softmax partials into the full softmax.

    ``m`` / ``l`` carry a split axis at ``axis``; ``acc`` the same axis
    plus a trailing feature dim.  Each split reweights by ``exp(m - M)``
    with ``M`` the max over splits: a split that saw no valid token has
    ``m == NEG_INF`` and weight exactly 0.0 in f32, so its partials are
    bitwise absent.  A row with no valid token anywhere stays finite.
    """
    axis = axis % m.dim()
    m_max = m.amax(dim=axis, keepdim=True)
    w = torch.exp(m - m_max)
    l_tot = (l * w).sum(dim=axis)
    num = (acc * w.unsqueeze(-1)).sum(dim=axis)
    return num / torch.clamp(l_tot, min=1e-30).unsqueeze(-1)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           splits: int = 1) -> torch.Tensor:
    """Decode attention straight off the page pool, no dense gather.

    q (B, 1, H, D); k/v pool (P, page_len, G, D); page_table (B, NB) int32
    (entry 0 = trash page); lengths (B,) int32 valid tokens per row.
    Returns (B, 1, H, D) in q's dtype."""
    b, _, h, d = q.shape
    g = k_pool.shape[2]
    nb = page_table.shape[1]
    pad = (-nb) % splits
    table = page_table.to(torch.int32)
    if pad:
        # trash-page columns sit past any valid length: never loaded
        table = F.pad(table, (0, pad))
    qg = q.reshape(b, g, h // g, d).contiguous()
    o, m, l = paged_attention(qg, k_pool, v_pool, table.contiguous(),
                              lengths.to(torch.int32).contiguous(), splits)
    out = merge_split_softmax(m, l, o, axis=2)           # (B, G, R, D)
    return out.reshape(b, 1, h, d).to(q.dtype)


def gather_traffic_counts(page_table, lengths, page_len: int):
    """(touched, total) page-read counts per decode tick, as floats:
    ``total`` is what a dense ``pool[table]`` gather streams (every table
    column of every slot), ``touched`` what the kernel's walk reads (pages
    holding at least one valid token)."""
    table = np.asarray(page_table)
    lens = np.asarray(lengths)
    total = float(table.shape[0] * table.shape[1])
    touched = float(np.sum(-(-lens // int(page_len))))
    return touched, total

