"""GQA attention: flash-style chunked prefill, KV-cache decode, and the
paged slot pool, dense or log2-quantized (forward only; port of
``src/repro/models/attention.py``).

Queries reshape to (B, S, G, R, D) with G = kv heads and R = group size,
so K/V are never repeated.  Scores and the PV product accumulate in
float32 (bf16 inputs widen exactly); ``p`` is cast to the V dtype before
PV, masked scores take the finite ``NEG_INF``, as in the reference.

Caches are updated in place, with the reference's write semantics: the
dense ``KVCache`` takes a scalar length (one-shot serving) or per-slot
``(B,)`` lengths (the continuous-batching slot pool), whose per-row writes
clamp their start to ``max_len - S`` as ``lax.dynamic_update_slice``
does; the paged ``PagedKVCache`` scatters rows into a shared page pool at
(page, offset) and redirects masked rows to the trash page 0, whose
colliding writes resolve as a serial scatter does (last row wins); the
log2-quantized ``QuantPagedKVCache`` stores each row as packed codes under
its page's power-of-two scale, plus a dense tail ring of each slot's two
newest pages.  Decode over a paged pool either gathers the slot's pages
into its dense view or, with ``cfg.paged_attn_kernel != "off"``, walks the
page table in the paged-attention kernels (``kernels/paged_attention``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.logquant import (dequantize_page_codes,
                                      quantize_page_codes, scale_exponent)
from repro_torch.models import sharding
from repro_torch.models.layers import apply_rope, dense, rms_norm

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
    When autograd records the call it runs as :class:`FlashAttention`,
    the reference's custom VJP: the backward recomputes each chunk's
    probabilities from the saved log-sum-exp, so the residuals are O(S),
    not every chunk's (B, G, R, Sq, C) probabilities.
    """
    b, sq, h, d = q.shape
    if sq == 1:
        return _decode_attention(q, k, v, q_positions, kv_positions,
                                 kv_valid_len)
    chunk = min(kv_chunk, k.shape[1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_positions, kv_positions,
                                    kv_valid_len, causal, chunk)
    return flash_forward(q, k, v, q_positions, kv_positions, causal, chunk,
                         kv_valid_len)[0]


def _padded_chunks(k, v, kv_positions, chunk: int):
    """K/V and their positions padded to whole chunks (pad keys sit at
    position 2**30, after every query), and the pad length."""
    pad = -k.shape[1] % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=2 ** 30)
    return k, v, kv_positions, pad


def _chunk_scores(qg, kb, pb, q_positions, ci, chunk, causal, kv_valid_len,
                  scale):
    """A chunk's masked f32 scores (B, G, R, Sq, C); masked keys take the
    finite ``NEG_INF``."""
    b, sq = qg.shape[:2]
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb.float()) * scale
    mask = torch.ones((b, 1, 1, sq, chunk), dtype=torch.bool,
                      device=qg.device)
    if causal:
        mask = (pb[:, None, None, None, :]
                <= q_positions[:, None, None, :, None])
    if kv_valid_len is not None:
        idx = ci * chunk + torch.arange(chunk, device=qg.device)
        mask = mask & (idx[None, None, None, None, :]
                       < kv_valid_len[:, None, None, None, None])
    return torch.where(mask, s, NEG_INF)


def flash_forward(q, k, v, q_positions, kv_positions, causal: bool,
                  chunk: int, kv_valid_len=None, stats: bool = False):
    """The chunked online-softmax forward in plain tensor ops:
    ``(out, out_g, lse)``, ``out`` (B, Sq, H, D) in q's dtype; with
    ``stats``, ``out_g`` (B, G, R, Sq, D) f32 and the log-sum-exp ``lse``
    (B, G, R, Sq) f32 the backward needs, else ``None``.  Autograd through
    it is the plain backward :class:`FlashAttention` replaces."""
    b, sq, h, d = q.shape
    g = k.shape[2]
    r = h // g
    k, v, kv_positions, _ = _padded_chunks(k, v, kv_positions, chunk)
    n_chunks = k.shape[1] // chunk
    scale = 1.0 / math.sqrt(d)
    qg = _grouped(q, g).float()
    m = torch.full((b, g, r, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, g, r, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, g, r, sq, d), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        s = _chunk_scores(qg, k[:, sl], kv_positions[:, sl], q_positions, ci,
                          chunk, causal, kv_valid_len, scale)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(q.dtype).float(),
                          v[:, sl].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out_g = acc / torch.clamp(l[..., None], min=1e-30)      # (B,G,R,Sq,D)
    out = out_g.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    if not stats:
        return out, None, None
    lse = m + torch.log(torch.clamp(l, min=1e-30))          # (B,G,R,Sq)
    return out, out_g, lse


class FlashAttention(torch.autograd.Function):
    """:func:`flash_forward` with the reference's custom VJP
    (``src/repro/models/attention.py`` ``_make_flash``).  It saves
    ``(q, k, v, positions, valid, out_g, lse)`` only; the backward walks
    the chunks again, recomputes ``P = exp(s - lse)``, and follows the
    reference's casts: ``dO`` in f32, ``delta = rowsum(dO * out_g)``, P
    cast to q's dtype before ``dV``, ``dS`` cast to q's dtype before
    ``dQ``/``dK``, every product accumulated in f32 (bf16 operands widen
    exactly), pad keys cut from ``dK``/``dV``.  Positions and the valid
    length get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, kv_valid_len,
                causal, chunk):
        out, out_g, lse = flash_forward(q, k, v, q_positions, kv_positions,
                                        causal, chunk, kv_valid_len,
                                        stats=True)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions,
                              kv_valid_len, out_g, lse)
        ctx.causal, ctx.chunk = causal, chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_positions, kv_positions, valid, out_g, lse = \
            ctx.saved_tensors
        causal, chunk = ctx.causal, ctx.chunk
        b, sq, h, d = q.shape
        skv, g = k.shape[1], k.shape[2]
        scale = 1.0 / math.sqrt(d)
        kp, vp, pp, _ = _padded_chunks(k, v, kv_positions, chunk)
        qg = _grouped(q, g).float()
        do = _grouped(dout, g).permute(0, 2, 3, 1, 4).float()  # (B,G,R,Sq,D)
        delta = (do * out_g).sum(dim=-1)                        # (B,G,R,Sq)
        dq = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
        dks, dvs = [], []
        for ci in range(kp.shape[1] // chunk):
            sl = slice(ci * chunk, (ci + 1) * chunk)
            kb, vb = kp[:, sl].float(), vp[:, sl].float()
            s = _chunk_scores(qg, kb, pp[:, sl], q_positions, ci, chunk,
                              causal, valid, scale)
            p = torch.exp(s - lse[..., None])                   # (B,G,R,Sq,C)
            dvs.append(torch.einsum("bgrqk,bgrqd->bkgd",
                                    p.to(q.dtype).float(), do))
            dp = torch.einsum("bgrqd,bkgd->bgrqk", do, vb)
            ds = p * (dp - delta[..., None]) * scale
            dsq = ds.to(q.dtype).float()
            dq = dq + torch.einsum("bgrqk,bkgd->bqgrd", dsq, kb)
            dks.append(torch.einsum("bgrqk,bqgrd->bkgd", dsq, qg))
        dk = torch.cat(dks, dim=1)[:, :skv]
        dv = torch.cat(dvs, dim=1)[:, :skv]
        return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None, None)


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


def _chunk_attention(q, k, v, q_positions, kv_positions, kv_valid_len):
    """q: (B, S, H, D) chunk queries against the full cache — the S-query
    form of :func:`_decode_attention`: one masked product and one softmax.
    Used by chunked prefill, whose queries must see earlier chunks' K/V
    in the cache, not only the fresh chunk's."""
    b, sq, h, d = q.shape
    g = k.shape[2]
    qg = _grouped(q, g).float()                          # (B, S, G, R, D)
    s = torch.einsum("bsgrd,bkgd->bgrsk", qg, k.float()) / math.sqrt(d)
    mask = (kv_positions[:, None, None, None, :]
            <= q_positions[:, None, None, :, None])
    if kv_valid_len is not None:
        idx = torch.arange(k.shape[1], device=q.device)
        mask = mask & (idx[None, None, None, None, :]
                       < kv_valid_len[:, None, None, None, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrsk,bkgd->bsgrd", p.to(q.dtype).float(), v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _at_card_width(attend, cut: int, q, k, v, *args, **kw):
    """``attend(q, k, v, ...)`` for a rank that holds 1/``cut`` of the
    heads, computed at one card's head count: the rank's heads sit in
    their own slots of zero-filled q, k and v of every head, so each
    product is one card's batched GEMM of the same shape.  cuBLAS may
    choose a batched GEMM's reduction order by its batch, and the heads
    are that batch, so a rank that attended over its own heads alone
    would round differently from one card; this way it keeps one card's
    bits, at ``cut`` times the attention products (not the projections).
    The paged kernels compute each head alone; K4's tail split, a product
    beside it, is widened the same way
    (``kernels.paged_attention.ops.paged_decode_attention_quant``)."""
    if cut == 1:
        return attend(q, k, v, *args, **kw)
    r = sharding.model_rank()

    def widen(t):
        b, s, n, d = t.shape
        full = t.new_zeros((b, s, n * cut, d))
        full[:, :, r * n:(r + 1) * n] = t
        return full
    h = q.shape[2]
    out = attend(widen(q), widen(k), widen(v), *args, **kw)
    return out[:, :, r * h:(r + 1) * h]


class KVCache(NamedTuple):
    k: torch.Tensor           # (B, S_max, G, D)
    v: torch.Tensor
    length: object            # int (whole batch) or (B,) int32 per slot


class PagedKVCache(NamedTuple):
    """Paged slot-pool KV: a pool of fixed-size pages shared by every slot;
    each slot's logical ``(max_len, G, D)`` cache is the run of pages its
    page-table row names.  Entry 0 is the trash page: masked writes go
    there, and nothing reads it unmasked."""
    k: torch.Tensor           # (P, page_len, G, D) page pool
    v: torch.Tensor
    page_table: torch.Tensor  # (B, n_blocks) int32 page ids, 0 = trash
    length: torch.Tensor      # (B,) int32 per-slot valid lengths


class QuantPagedKVCache(NamedTuple):
    """Log2-quantized page pool (``ServeConfig(kv_quant=True)``): pages
    hold packed ``core.logquant`` wire codes and one power-of-two scale
    exponent per (page, head); each slot's newest two pages also stay
    dense in its tail ring, so decode-adjacent tokens read what the dense
    pool would hold.  A row's codes are a pure function of its value and
    its page's first-row scale, so rewriting a position reproduces the
    same bytes."""
    k_codes: torch.Tensor     # (P, page_len, G, D) packed codes
    v_codes: torch.Tensor
    k_scale: torch.Tensor     # (P, G) int32 scale exponents
    v_scale: torch.Tensor
    k_tail: torch.Tensor      # (B, 2*page_len + 1, G, D); last row = junk
    v_tail: torch.Tensor
    page_table: torch.Tensor  # (B, n_blocks) int32 page ids, 0 = trash
    length: torch.Tensor      # (B,) int32 per-slot valid lengths


def last_writer(dest: torch.Tensor, size: int) -> torch.Tensor:
    """For each of N scatter rows with destinations ``dest`` (N,) in
    ``[0, size)``, the index of the last row that writes the same
    destination.  Scattering every row's value from its last writer
    resolves duplicate destinations as a serial scatter does (the last
    row wins), on every device and run alike: CUDA's ``index_put_``
    lets racing duplicates land in any order, and a free slot reads the
    trash page such duplicates write."""
    order = torch.arange(dest.numel(), device=dest.device)
    last = torch.full((size,), -1, dtype=torch.long, device=dest.device)
    last.scatter_reduce_(0, dest, order, reduce="amax")
    return last[dest]


class PageSlots(NamedTuple):
    """Where an S-row paged write lands: ``page``/``off`` (B, S), rows
    outside the slot's pages or masked at (trash page, 0); ``in_alloc``
    (B, S); ``src`` (B*S,) each row's last writer (:func:`last_writer`)."""
    page: torch.Tensor
    off: torch.Tensor
    in_alloc: torch.Tensor
    src: torch.Tensor


def page_slots(table: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
               n_pages: int, page_len: int) -> PageSlots:
    """Slots of rows at absolute positions ``pos`` (B, S): page
    ``table[b, pos // page_len]``, offset ``pos % page_len``; rows where
    ``keep`` is False or whose block lies past the table go to the trash
    page, offset 0."""
    nb = table.shape[1]
    blk = torch.clamp(pos // page_len, 0, nb - 1).long()
    page = torch.gather(table.long(), 1, blk)
    in_alloc = keep & (pos // page_len < nb)
    page = torch.where(in_alloc, page, 0)
    off = torch.where(in_alloc, pos % page_len, 0).long()
    src = last_writer((page * page_len + off).reshape(-1), n_pages * page_len)
    return PageSlots(page, off, in_alloc, src)


def _paged_write(pool: torch.Tensor, slots: PageSlots,
                 new: torch.Tensor) -> torch.Tensor:
    """Scatter ``new`` (B, S, G, D) rows into the page pool at ``slots``,
    in place."""
    vals = new.reshape((-1,) + tuple(new.shape[2:]))[slots.src]
    pool[slots.page.reshape(-1), slots.off.reshape(-1)] = vals.to(pool.dtype)
    return pool


def _quant_paged_write(codes: torch.Tensor, scale: torch.Tensor,
                       tail: torch.Tensor, table: torch.Tensor,
                       new: torch.Tensor, pos: torch.Tensor,
                       keep: torch.Tensor, start: torch.Tensor, adv,
                       n_bits: int, slots: Optional[PageSlots] = None) -> None:
    """Quantize ``new`` (B, S, G, D) rows at ``pos`` (B, S) into the code
    pool ``(P, page_len, G, D)``, the scales ``(P, G)`` and the tail ring
    ``(B, 2*page_len + 1, G, D)``, in place.  ``start`` (B,) is the length
    before the write, ``adv`` the per-row advance.

    * codes: a row whose page starts inside this write takes the scale of
      the page's first row; a row of an older page the pool's stored
      scale, read before this write's scale scatter.
    * scales: only offset-0 rows own their page's entry; every other row
      writes the trash page's entry.
    * tail ring: rows within the newest ``2*page_len`` positions land at
      ``pos % (2*page_len)``; older and masked rows at the junk bin.

    Masked rows go to the trash page as in :func:`page_slots` (``slots``,
    when the caller already has them).  Writes that land on the trash
    page collide and resolve as :func:`last_writer` says; those that land
    on the junk bin collide too, and nothing reads that."""
    page_len = codes.shape[1]
    b, s = pos.shape
    g, d = new.shape[2:]
    if slots is None:
        slots = page_slots(table, pos, keep, codes.shape[0], page_len)
    page, off, in_alloc = slots.page, slots.off, slots.in_alloc

    start = start.expand(b)
    p0 = pos - pos % page_len                     # each row's page start
    own = p0 >= start[:, None]                    # page starts in this write
    j0 = torch.clamp(p0 - start[:, None], 0, s - 1).long()
    row0 = torch.gather(new, 1, j0[..., None, None].expand(b, s, g, d))
    own_se = scale_exponent(row0, dim=-1)         # (B, S, G)
    se = torch.where(own[..., None], own_se, scale[page])
    qcodes = quantize_page_codes(new, se[..., None], n_bits)
    codes[page.reshape(-1), off.reshape(-1)] = qcodes.reshape(
        -1, g, d)[slots.src].to(codes.dtype)
    sp = torch.where(in_alloc & (pos % page_len == 0), page, 0).reshape(-1)
    scale[sp] = own_se.reshape(-1, g)[last_writer(sp, scale.shape[0])]

    ring = 2 * page_len
    in_ring = in_alloc & (pos >= (start + adv)[:, None] - ring)
    toff = torch.where(in_ring, pos % ring, ring).long()
    bidx = torch.arange(b, device=pos.device)[:, None].expand(b, s)
    tail[bidx.reshape(-1), toff.reshape(-1)] = new.reshape(-1, g, d).to(
        tail.dtype)


def _quant_paged_gather(codes: torch.Tensor, scale: torch.Tensor,
                        tail: torch.Tensor, table: torch.Tensor,
                        lengths: torch.Tensor, n_bits: int,
                        dtype) -> torch.Tensor:
    """The dense logical view ``(B, n_blocks * page_len, G, D)`` of a
    quantized pool: each page dequantized under its scale, the newest page
    (block ``(length - 1) // page_len``) read from the tail ring instead.
    Junk rows decode finite and are masked by the caller."""
    from repro_torch.kernels.paged_attention.ops import tail_rows

    b, nb = table.shape
    page_len = codes.shape[1]
    t = table.long()
    deq = dequantize_page_codes(codes[t], scale[t][:, :, None, :, None],
                                n_bits, dtype)     # (B, nb, pl, G, D)
    rows, tb = tail_rows(tail, lengths, page_len)
    use_tail = torch.arange(nb, device=t.device)[None] == tb[:, None]
    out = torch.where(use_tail[:, :, None, None, None],
                      rows[:, None].to(dtype), deq)
    return out.reshape((b, nb * page_len) + tuple(codes.shape[2:]))


def _paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each slot's pages as its dense logical view: ``(P, page_len, G, D)``
    pool + ``(B, n_blocks)`` table -> ``(B, n_blocks * page_len, G, D)``;
    junk rows (trash, unwritten) are masked by the caller."""
    b, nb = table.shape
    g = pool[table.long()]                   # (B, nb, page_len, G, D)
    return g.reshape((b, nb * pool.shape[1]) + tuple(pool.shape[2:]))


def _slab_rows(length: torch.Tensor, s: int, s_max: int):
    """Row indices of an S-row per-slot write at each row's ``length``,
    the start clamped to ``[0, s_max - s]`` as ``dynamic_update_slice``
    clamps it in the reference."""
    start = torch.clamp(length.long(), 0, s_max - s)
    return start[:, None] + torch.arange(s, device=length.device)


def attention(p, x: torch.Tensor, positions: torch.Tensor, cfg,
              cache=None, quant=False,
              chunk_valid: Optional[torch.Tensor] = None):
    """GQA block body (pre-norm residual handled by the caller).

    ``wq/wk/wv`` take the biases ``bq/bk/bv`` when the block has them
    (``qkv_bias``); with ``cfg.qk_norm``, q and k are RMS-normed over
    ``head_dim`` before RoPE, on every cache branch.

    Returns ``(attn_out, new_cache)``.  With a dense ``KVCache``, ``x`` is
    appended at ``cache.length``: a prompt (the cache assumed empty before;
    attend over the fresh K/V) or one decode token (attend over the
    cache).  ``chunk_valid`` (``(B,)``, chunked prefill) makes ``x`` one
    right-padded mid-prompt chunk per row: only its first ``chunk_valid[b]``
    rows are written and queries attend over the cache.  With a
    ``PagedKVCache`` the same writes scatter into pages (with a
    ``QuantPagedKVCache`` they quantize on the way); an S = 1 read goes
    through a paged-attention kernel when ``cfg.paged_attn_kernel`` is not
    ``"off"``, else through the gathered view.

    On a model axis (``models.sharding``) a rank may hold whole kv heads
    and their q groups (``wq/wk/wv`` and their biases column-parallel,
    ``wo`` row-parallel, the cache its local heads; the products outside
    the paged kernels run at one card's head count, :func:`_at_card_width`),
    or, when the kv heads
    do not divide the ranks, every head: then the paged kernels spread
    their split-KV runs over the ranks (``spread``, case B of
    ``kernels.paged_attention.ops``).
    """
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(p["wq"], x, p.get("bq"), p.get("wq_q") if quant else None,
              ctx=quant)
    cut = sharding.cut_of(h * hd, q.shape[-1], "attention q heads")
    h, hkv = h // cut, hkv // cut
    spread = cut == 1 and sharding.model_size() > 1
    k = dense(p["wk"], x, p.get("bk"), p.get("wk_q") if quant else None,
              ctx=quant)
    v = dense(p["wv"], x, p.get("bv"), p.get("wv_q") if quant else None,
              ctx=quant)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = _at_card_width(flash_attention, cut, q, k, v, positions,
                             positions, causal=True, kv_chunk=cfg.kv_chunk)
        new_cache = None
    elif isinstance(cache, (PagedKVCache, QuantPagedKVCache)):
        ar = torch.arange(s, dtype=torch.int32, device=x.device)
        pos = cache.length[:, None] + ar[None]
        if chunk_valid is not None:
            keep = ar[None] < chunk_valid[:, None]
            adv = chunk_valid
        else:
            keep = torch.ones((b, s), dtype=torch.bool, device=x.device)
            adv = s
        new_len = cache.length + adv
        kernel = s == 1 and getattr(cfg, "paged_attn_kernel", "off") != "off"
        splits = getattr(cfg, "paged_attn_splits", 1)
        table = cache.page_table
        if isinstance(cache, QuantPagedKVCache):
            n_bits = getattr(cfg, "kv_bits", 4)
            slots = page_slots(table, pos, keep, cache.k_codes.shape[0],
                               cache.k_codes.shape[1])
            _quant_paged_write(cache.k_codes, cache.k_scale, cache.k_tail,
                               table, k, pos, keep, cache.length, adv, n_bits,
                               slots)
            _quant_paged_write(cache.v_codes, cache.v_scale, cache.v_tail,
                               table, v, pos, keep, cache.length, adv, n_bits,
                               slots)
            if kernel:
                from repro_torch.kernels.paged_attention.ops import \
                    paged_decode_attention_quant
                out = paged_decode_attention_quant(
                    q, cache.k_codes, cache.k_scale, cache.v_codes,
                    cache.v_scale, cache.k_tail, cache.v_tail, table,
                    new_len, n_bits=n_bits, splits=splits, spread=spread,
                    cut=cut)
            else:
                kg = _quant_paged_gather(cache.k_codes, cache.k_scale,
                                         cache.k_tail, table, new_len,
                                         n_bits, cache.k_tail.dtype)
                vg = _quant_paged_gather(cache.v_codes, cache.v_scale,
                                         cache.v_tail, table, new_len,
                                         n_bits, cache.v_tail.dtype)
        else:
            slots = page_slots(table, pos, keep, cache.k.shape[0],
                               cache.k.shape[1])
            _paged_write(cache.k, slots, k)
            _paged_write(cache.v, slots, v)
            if kernel:
                from repro_torch.kernels.paged_attention.ops import \
                    paged_decode_attention
                out = paged_decode_attention(q, cache.k, cache.v, table,
                                             new_len, splits=splits,
                                             spread=spread)
            else:
                kg = _paged_gather(cache.k, table)
                vg = _paged_gather(cache.v, table)
        if not kernel:
            kv_pos = torch.arange(kg.shape[1], dtype=torch.int32,
                                  device=x.device).expand(b, -1)
            attend = _decode_attention if s == 1 else _chunk_attention
            out = _at_card_width(attend, cut, q, kg, vg, positions, kv_pos,
                                 new_len)
        new_cache = cache._replace(length=new_len)
    elif chunk_valid is not None:
        # write only the real slab rows (pad rows write the cache's own
        # bytes back), then attend over the cache
        s_max = cache.k.shape[1]
        length = cache.length
        if not torch.is_tensor(length):
            length = torch.full((b,), length, dtype=torch.int32,
                                device=x.device)
        rows = _slab_rows(length, s, s_max)
        bi = torch.arange(b, device=x.device)[:, None]
        keep = (torch.arange(s, device=x.device)[None]
                < chunk_valid[:, None])[..., None, None]
        for c, n in ((cache.k, k), (cache.v, v)):
            c[bi, rows] = torch.where(keep, n.to(c.dtype), c[bi, rows])
        new_len = length + chunk_valid
        kv_pos = torch.arange(s_max, dtype=torch.int32,
                              device=x.device).expand(b, -1)
        out = _at_card_width(_chunk_attention, cut, q, cache.k, cache.v,
                             positions, kv_pos, new_len)
        new_cache = KVCache(k=cache.k, v=cache.v, length=new_len)
    else:
        s_max = cache.k.shape[1]
        idx = cache.length
        if torch.is_tensor(idx) and idx.dim() == 1:
            # per-slot (B,) lengths: each row appends at its own offset
            rows = _slab_rows(idx, s, s_max)
            bi = torch.arange(b, device=x.device)[:, None]
            cache.k[bi, rows] = k.to(cache.k.dtype)
            cache.v[bi, rows] = v.to(cache.v.dtype)
            valid = idx + s
        else:
            if idx + s > s_max:
                raise ValueError(f"cache of {s_max} rows cannot take {s} "
                                 f"tokens at {idx}")
            cache.k[:, idx:idx + s] = k.to(cache.k.dtype)
            cache.v[:, idx:idx + s] = v.to(cache.v.dtype)
            valid = torch.full((b,), idx + s, dtype=torch.int32,
                               device=x.device)
        new_len = idx + s
        if s == 1:
            kv_pos = torch.arange(s_max, dtype=torch.int32,
                                  device=x.device).expand(b, -1)
            out = _at_card_width(flash_attention, cut, q, cache.k, cache.v,
                                 positions, kv_pos, causal=True,
                                 kv_chunk=cfg.kv_chunk, kv_valid_len=valid)
        else:
            out = _at_card_width(flash_attention, cut, q, k, v, positions,
                                 positions, causal=True,
                                 kv_chunk=cfg.kv_chunk)
        new_cache = KVCache(k=cache.k, v=cache.v, length=new_len)

    out = out.reshape(b, s, h * hd)
    y = dense(p["wo"], out, quant=p.get("wo_q") if quant else None,
              ctx=quant, reduce=cut > 1)
    return y, new_cache
