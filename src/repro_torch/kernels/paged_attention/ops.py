"""Wrappers for the CUDA paged-attention decode kernels, their plain
PyTorch versions, the split merge and the page-traffic accounting (port of
``src/repro/kernels/paged_attention/ops.py`` and of ``make_page_table`` /
``RAGGED512`` from its ``kernel.py``).

``paged_attention(qg, k_pool, v_pool, page_table, lengths, splits)``
(``csrc/paged_attention.cu``, the dense pool) and
``paged_attention_quant(qg, k_codes, k_scale, v_codes, v_scale, page_table,
lengths, n_bits, splits)`` (``csrc/paged_attention_quant.cu``, the
log2-quantized pool, dequantized in registers) return the unnormalised
split partials ``(o, m, l)``.  A CUDA tensor launches the kernel on the
current stream (or raises); a CPU tensor runs the plain version
(:func:`paged_attention_plain`, :func:`paged_attention_quant_plain`).
Each wrapper's ``launches`` counts its kernel launches.
:func:`paged_decode_attention` and :func:`paged_decode_attention_quant`
are the model's entries: grouped reshape, trash-column padding of the
table to a multiple of ``splits``, the partials (for the quantized pool
over full pages only, plus the newest page as one dense split from the
tail ring), :func:`merge_split_softmax`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.logquant import code_dtype, dequantize_page_codes
from repro_torch.kernels import _build

NEG_INF = -1e30

_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_CODE_KINDS = {torch.int8: 0, torch.int16: 1}

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


def _walk_plain(qg: torch.Tensor, pages, page_table: torch.Tensor,
                lengths: torch.Tensor, page_len: int, splits: int):
    """The online-softmax page walk of both kernels in plain PyTorch: each
    split walks its pages in order (f32 statistics, masked ``p`` exactly
    0, ``p`` cast to the V pages' dtype before PV), all (slot, head,
    split) cells at once.  ``pages(ids)`` returns the K and V pages that
    ``ids (B, S)`` names, each ``(B, S, page_len, G, D)``.  A page wholly
    past a row's length leaves that row's state untouched, as the
    kernels, which do not load it, do."""
    b, g, r, d = qg.shape
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
        kb, vb = pages(table[:, :, j])               # (B, S, pl, G, D)
        s = torch.einsum("bgrd,bstgd->bgsrt", q, kb.float()) / scale
        start = (split_base + j) * page_len          # (S,)
        pos = start[:, None] + offs                  # (S, pl)
        valid = (pos[None] < lens[:, None, None])[:, None, :, None, :]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
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


def paged_attention_plain(qg: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, splits: int = 1):
    """The dense kernel's function (the reference's ``_paged_attn_kernel``)
    in plain PyTorch: the page walk over the pool's pages, ``p`` rounded to
    the pool dtype before PV.  Masked ``p`` underflows to 0 there anyway:
    a page the walk keeps holds a valid position."""
    return _walk_plain(qg, lambda ids: (k_pool[ids], v_pool[ids]),
                       page_table, lengths, k_pool.shape[1], splits)


def _check_walk(qg, k_pool, v_pool, page_table, lengths, splits, *others):
    """The checks both wrappers share; returns ``(b, g, r, d, n_pages,
    page_len, nb)``."""
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
    operands = (qg, k_pool, v_pool, page_table, lengths, *others)
    if len({t.device for t in operands}) != 1:
        raise ValueError("all operands must share one device")
    if qg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"paged attention runs on CUDA or CPU, not "
                         f"{qg.device}")
    if qg.device.type == "cuda" and not all(t.is_contiguous()
                                            for t in operands):
        raise ValueError("the paged-attention kernels need contiguous "
                         "inputs")
    return b, g, r, d, n_pages, page_len, nb


def paged_attention(qg: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, splits: int = 1):
    """qg (B, G, R, D); k/v pool (P, page_len, G, D); page_table (B, NB)
    int32 with NB a multiple of ``splits``; lengths (B,) int32.  Returns
    ``(o, m, l)``: o (B, G, splits, R, D) f32, m/l (B, G, splits, R) f32 —
    merge with :func:`merge_split_softmax`."""
    b, g, r, d, n_pages, page_len, nb = _check_walk(qg, k_pool, v_pool,
                                                    page_table, lengths,
                                                    splits)
    if qg.device.type == "cpu":
        return paged_attention_plain(qg, k_pool, v_pool, page_table, lengths,
                                     splits)
    if qg.dtype not in _KINDS or not qg.dtype == k_pool.dtype == v_pool.dtype:
        raise TypeError(f"q and the pools must share one dtype, f32 or "
                        f"bf16, got {qg.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
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
        _build.count_launch(paged_attention)
    return o, m, l


paged_attention.launches = 0


def _lib_quant():
    lib = _build.library("paged_attention_quant")
    if lib.qh_paged_attention_quant.argtypes is None:
        lib.qh_paged_attention_quant.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.qh_paged_attention_quant.restype = ctypes.c_int
        lib.qh_paged_attention_quant_error_string.argtypes = [ctypes.c_int]
        lib.qh_paged_attention_quant_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention_quant_plain(qg: torch.Tensor, k_codes: torch.Tensor,
                                k_scale: torch.Tensor, v_codes: torch.Tensor,
                                v_scale: torch.Tensor,
                                page_table: torch.Tensor,
                                lengths: torch.Tensor, n_bits: int = 4,
                                splits: int = 1):
    """The quantized kernel's function (the reference's
    ``_paged_attn_quant_kernel``) in plain PyTorch: the page walk over
    pages dequantized to f32 under their (page, head) scales, so ``p``
    stays f32; masked ``p`` is exactly 0 against garbage that decodes up
    to 2^127."""
    def pages(ids):
        return tuple(dequantize_page_codes(c[ids], sc[ids][:, :, None, :, None],
                                           n_bits)
                     for c, sc in ((k_codes, k_scale), (v_codes, v_scale)))
    return _walk_plain(qg, pages, page_table, lengths, k_codes.shape[1],
                       splits)


def paged_attention_quant(qg: torch.Tensor, k_codes: torch.Tensor,
                          k_scale: torch.Tensor, v_codes: torch.Tensor,
                          v_scale: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, n_bits: int = 4,
                          splits: int = 1):
    """qg (B, G, R, D) f32 or bf16; code pools (P, page_len, G, D) of
    ``code_dtype(n_bits)``; scale pools (P, G) int32; page_table (B, NB)
    int32 with NB a multiple of ``splits``; lengths (B,) int32 (the
    decode path passes them floored to full pages).  Returns ``(o, m, l)``
    as :func:`paged_attention` does."""
    b, g, r, d, n_pages, page_len, nb = _check_walk(
        qg, k_codes, v_codes, page_table, lengths, splits, k_scale, v_scale)
    if tuple(k_scale.shape) != (n_pages, g) \
            or v_scale.shape != k_scale.shape:
        raise ValueError(f"scale pools must be (P, G) = {(n_pages, g)}, got "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")
    if not 2 <= n_bits <= 8:
        raise ValueError(f"n_bits={n_bits} must be in [2, 8]")
    if not k_codes.dtype == v_codes.dtype == code_dtype(n_bits):
        raise TypeError(f"codes must be {code_dtype(n_bits)} at n_bits="
                        f"{n_bits}, got {k_codes.dtype}, {v_codes.dtype}")
    if not k_scale.dtype == v_scale.dtype == torch.int32:
        raise TypeError("scale pools must be int32")
    if qg.device.type == "cpu":
        return paged_attention_quant_plain(qg, k_codes, k_scale, v_codes,
                                           v_scale, page_table, lengths,
                                           n_bits, splits)
    if qg.dtype not in _KINDS:
        raise TypeError(f"q must be f32 or bf16, got {qg.dtype}")
    dev = qg.device
    o = torch.empty((b, g, splits, r, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, g, splits, r), dtype=torch.float32, device=dev)
    l = torch.empty((b, g, splits, r), dtype=torch.float32, device=dev)
    if b and g and r:
        lib = _lib_quant()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qh_paged_attention_quant(
            qg.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
            v_codes.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            b, g, r, d, page_len, nb, splits, n_pages, n_bits,
            _KINDS[qg.dtype], _CODE_KINDS[k_codes.dtype], stream)
        if rc != 0:
            raise RuntimeError(
                "paged_attention_quant launch failed: "
                + lib.qh_paged_attention_quant_error_string(rc).decode())
        _build.count_launch(paged_attention_quant)
    return o, m, l


paged_attention_quant.launches = 0


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


def rank_runs(page_table: torch.Tensor, lengths: torch.Tensor,
              page_len: int, splits: int):
    """This rank's share of a split-KV walk spread over the model axis
    (``models.sharding``; the reference's ``kvsplit`` rule): with M ranks
    dividing ``splits``, rank r walks splits ``[r*S/M, (r+1)*S/M)``, i.e.
    its run of ``NB/M`` table columns, with lengths shifted by the run's
    first position (clamped at 0).  A kernel derives every position from
    its column and the length, so each split's partials are the bits the
    one-rank call computes.  Returns ``(table, lengths, splits)`` for the
    rank, or None (no model axis, or M does not divide ``splits``)."""
    from repro_torch.models import sharding as sh

    m = sh.model_size()
    if m == 1 or splits % m:
        return None
    cols = page_table.shape[1] // m
    run = sh.rank_slice(cols)
    lens = torch.clamp(lengths - run.start * page_len, min=0)
    return (page_table[:, run].contiguous(), lens.to(torch.int32),
            splits // m)


def gather_runs(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor):
    """The ranks' ``(o, m, l)`` partials concatenated along the split axis
    (dim 2) in rank order, in one collective: the one-rank partials."""
    from repro_torch.models import sharding as sh

    d = o.shape[-1]
    packed = torch.cat([o, m[..., None], l[..., None]], dim=-1)
    packed = sh.all_gather(packed, 2)
    return packed[..., :d], packed[..., d], packed[..., d + 1]


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           splits: int = 1,
                           spread: bool = False) -> torch.Tensor:
    """Decode attention straight off the page pool, no dense gather.

    q (B, 1, H, D); k/v pool (P, page_len, G, D); page_table (B, NB) int32
    (entry 0 = trash page); lengths (B,) int32 valid tokens per row.
    ``spread=True`` on a model axis whose size divides ``splits`` walks
    only this rank's split runs and gathers the ranks' partials before
    the merge (:func:`rank_runs`): the result is the one-rank call's.
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
    lengths = lengths.to(torch.int32).contiguous()
    runs = rank_runs(table, lengths, k_pool.shape[1], splits) \
        if spread else None
    if runs is None:
        o, m, l = paged_attention(qg, k_pool, v_pool, table.contiguous(),
                                  lengths, splits)
    else:
        o, m, l = gather_runs(*paged_attention(qg, k_pool, v_pool, *runs))
    out = merge_split_softmax(m, l, o, axis=2)           # (B, G, R, D)
    return out.reshape(b, 1, h, d).to(q.dtype)


def tail_rows(tail: torch.Tensor, lengths: torch.Tensor, page_len: int):
    """Each row's newest page from its tail ring ``(B, 2*page_len + 1, G,
    D)``: block ``tb = (length - 1) // page_len`` (0 for an empty row),
    whose positions ``[tb * page_len, (tb + 1) * page_len)`` sit in ring
    half ``tb % 2``.  Returns the rows ``(B, page_len, G, D)`` and ``tb``
    (B,) int64."""
    tb = torch.clamp(lengths.long() - 1, min=0) // page_len
    idx = (tb % 2)[:, None] * page_len + torch.arange(page_len,
                                                      device=tail.device)
    bidx = torch.arange(tail.shape[0], device=tail.device)[:, None]
    return tail[bidx, idx], tb


def paged_decode_attention_quant(q: torch.Tensor, k_codes: torch.Tensor,
                                 k_scale: torch.Tensor, v_codes: torch.Tensor,
                                 v_scale: torch.Tensor, k_tail: torch.Tensor,
                                 v_tail: torch.Tensor,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor, *, n_bits: int = 4,
                                 splits: int = 1,
                                 spread: bool = False,
                                 cut: int = 1) -> torch.Tensor:
    """Decode attention off the log2-quantized page pool.

    q (B, 1, H, D); code pools (P, page_len, G, D); scale pools (P, G)
    int32; tail rings (B, 2*page_len + 1, G, D) in the cache dtype;
    page_table (B, NB) int32; lengths (B,) int32.  The kernel walks full
    pages only (lengths floored to a page multiple: the newest page's
    codes are still being rewritten); the newest page is one more split,
    computed here from the tail ring in f32 with ``p`` cast to the ring's
    dtype before PV, as the dense pool would be read, and merged with the
    kernel's partials.  ``spread`` spreads the kernel's splits over the
    ranks as :func:`paged_decode_attention` does; every rank computes the
    tail split.  ``cut > 1``: this rank holds 1/``cut`` of the heads, and
    the tail split and the merge run at one card's head count (the rank's
    heads in their own slots, zeros elsewhere), so that their batched
    products round as one card's do.  Returns (B, 1, H, D) in q's
    dtype."""
    b, _, h, d = q.shape
    page_len, g = k_codes.shape[1], k_codes.shape[2]
    nb = page_table.shape[1]
    table = page_table.to(torch.int32)
    if (-nb) % splits:
        table = F.pad(table, (0, (-nb) % splits))
    qg = q.reshape(b, g, h // g, d).contiguous()
    lengths = lengths.to(torch.int32)
    kt, tb = tail_rows(k_tail, lengths, page_len)        # (B, pl, G, D)
    vt, _ = tail_rows(v_tail, lengths, page_len)
    kern_lens = (tb * page_len).to(torch.int32)          # full pages only
    runs = rank_runs(table, kern_lens, page_len, splits) if spread else None
    if runs is None:
        o, m, l = paged_attention_quant(qg, k_codes, k_scale, v_codes,
                                        v_scale, table.contiguous(),
                                        kern_lens, n_bits, splits)
    else:
        tab, lens, sp = runs
        o, m, l = gather_runs(*paged_attention_quant(
            qg, k_codes, k_scale, v_codes, v_scale, tab, lens, n_bits, sp))
    if cut > 1:
        from repro_torch.models import sharding as sh

        run = sh.rank_slice(g)

        def widen(t, dim):
            shape = list(t.shape)
            shape[dim] *= cut
            full = t.new_zeros(shape)
            full.narrow(dim, run.start, g).copy_(t)
            return full
        qg, o, m, l = (widen(t, 1) for t in (qg, o, m, l))
        kt, vt = widen(kt, 2), widen(vt, 2)
    pos = tb[:, None] * page_len + torch.arange(page_len, device=q.device)
    s_t = torch.einsum("bgrd,bkgd->bgrk", qg.float(), kt.float()) \
        / math.sqrt(d)
    s_t = torch.where(pos[:, None, None, :] < lengths[:, None, None, None],
                      s_t, NEG_INF)
    m_t = s_t.amax(dim=-1, keepdim=True)                 # (B, G, R, 1)
    p = torch.exp(s_t - m_t)
    acc_t = torch.einsum("bgrk,bkgd->bgrd", p.to(vt.dtype).float(),
                         vt.float())
    o = torch.cat([o, acc_t[:, :, None]], dim=2)
    m = torch.cat([m, m_t[..., 0][:, :, None]], dim=2)
    l = torch.cat([l, p.sum(dim=-1)[:, :, None]], dim=2)
    out = merge_split_softmax(m, l, o, axis=2)           # (B, G, R, D)
    if cut > 1:
        out = out[:, run]
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

