"""Dense attention decoder (port of ``src/repro/models/model.py`` for
``pattern=("attn",)``).

Parameters keep the reference's layout: one block dict whose leaves are
stacked over the ``R`` repeats (leading dim), weights ``(K, N)``.  Where
the reference scans over repeats, :func:`forward` runs a Python loop over
layer views of the stacked leaves.  Caches are ``(R, B, max_len, G, D)``
per K/V and are updated in place; the paged slot pool
(:func:`init_paged_pool`) is ``(R, n_pages, page_len, G, D)`` per K/V, or
with ``kv_quant`` packed log2 codes, per-page scales and a tail ring.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.logquant import code_dtype
from repro_torch.core.shiftadd import QuantizedLinearParams, as_quant_ctx
from repro_torch.models.attention import (KVCache, PagedKVCache,
                                          QuantPagedKVCache, attention)
from repro_torch.models.layers import rms_norm, swiglu

Params = Dict[str, Any]


@dataclass(frozen=True)
class ModelConfig:
    """The dense-decoder fields of the reference's ``ModelConfig``, with
    torch dtypes (the MoE, SSM and frontend fields belong to later slices
    of the port).

    ``paged_attn_kernel``: ``"off"`` reads the paged pool through the
    dense gather; ``"pallas"`` (the reference's name) through the CUDA
    paged-attention kernel with ``paged_attn_splits`` split-KV partials.
    Only the paged decode path reads them.  ``kv_quant`` makes
    :func:`init_paged_pool` build the log2-quantized page pool at
    ``kv_bits`` exponent bits."""

    name: str
    d_model: int
    n_layers: int
    d_ff: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    pattern: Tuple[str, ...] = ("attn",)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    cache_dtype: Any = None           # None -> io dtype
    kv_chunk: int = 1024
    paged_attn_kernel: str = "off"    # off | pallas
    paged_attn_splits: int = 1
    kv_quant: bool = False
    kv_bits: int = 4

    @property
    def repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.n_layers} layers not divisible by period {len(self.pattern)}"
        return self.n_layers // len(self.pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _check_dense(cfg: ModelConfig) -> None:
    if tuple(cfg.pattern) != ("attn",):
        raise NotImplementedError(f"pattern {cfg.pattern}: only the dense "
                                  "attention decoder is ported")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _normal(shape, gen: torch.Generator, dev: torch.device, scale: float,
            dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(device=dev, dtype=dtype)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random weights with the reference's shapes and scales: embeddings
    N(0, 0.02), projections N(0, 1/sqrt(K)), norms 1.  ``generator``
    defaults to one seeded with 0 on ``device``."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    dt, r = cfg.dtype, cfg.repeats
    d, h, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)

    def proj(k, n):
        return _normal((r, k, n), gen, dev, 1.0 / k ** 0.5, dt)

    block = {
        "ln1": torch.ones((r, d), dtype=dt, device=dev),
        "wq": proj(d, h * hd), "wk": proj(d, hkv * hd),
        "wv": proj(d, hkv * hd), "wo": proj(h * hd, d),
        "ln2": torch.ones((r, d), dtype=dt, device=dev),
        "mlp": {"gate": proj(d, ff), "up": proj(d, ff), "down": proj(ff, d)},
    }
    params: Params = {
        "embed": _normal((cfg.vocab_size, d), gen, dev, 0.02, dt),
        "blocks": (block,),
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal((d, cfg.vocab_size), gen, dev, 0.02, dt)
    return params


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                device=None, per_slot: bool = False) -> Params:
    """Stacked (over repeats) K/V caches, zero-filled.  ``length`` is the
    int 0, or with ``per_slot=True`` a ``(batch,)`` int32 tensor, one valid
    length per row (the continuous-batching slot pool)."""
    dev = resolve_device(device)
    length = (torch.zeros((batch,), dtype=torch.int32, device=dev)
              if per_slot else 0)
    return _kv_caches(cfg, (batch, max_len), dtype, dev, length)


def init_paged_pool(cfg: ModelConfig, batch: int, max_len: int,
                    n_pages: int, page_len: int, dtype=None,
                    device=None) -> Params:
    """Paged slot-pool caches: attention K/V in a shared page pool
    ``(R, n_pages, page_len, G, D)`` indexed through host-built per-slot
    page tables (page 0 is the trash page, ``serving.kvpool``); per-slot
    ``(batch,)`` lengths.  ``max_len`` must be a multiple of ``page_len``
    so a slot's gathered view has the dense slab's shape.

    ``cfg.kv_quant=True`` stores the pool as packed log2 wire codes
    ``{k,v}_codes (R, n_pages, page_len, G, D)`` (``code_dtype(kv_bits)``),
    per-(page, head) power-of-two scale exponents ``{k,v}_scale (R,
    n_pages, G)`` int32, and a dense per-slot tail ring ``{k,v}_tail (R,
    batch, 2*page_len + 1, G, D)`` in the cache dtype holding each slot's
    newest two pages (row ``2*page_len`` is the junk bin)."""
    if max_len % page_len:
        raise ValueError(f"max_len={max_len} must be a multiple of "
                         f"page_len={page_len}")
    dev = resolve_device(device)
    length = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if not cfg.kv_quant:
        return _kv_caches(cfg, (n_pages, page_len), dtype, dev, length)
    _check_dense(cfg)
    dtype = dtype or cfg.cache_dtype or cfg.dtype
    r, g, d = cfg.repeats, cfg.n_kv_heads, cfg.head_dim
    ct = code_dtype(cfg.kv_bits)
    layer = {}
    for k in ("k", "v"):
        layer[f"{k}_codes"] = torch.zeros((r, n_pages, page_len, g, d),
                                          dtype=ct, device=dev)
        layer[f"{k}_scale"] = torch.zeros((r, n_pages, g),
                                          dtype=torch.int32, device=dev)
        layer[f"{k}_tail"] = torch.zeros((r, batch, 2 * page_len + 1, g, d),
                                         dtype=dtype, device=dev)
    return {"layers": (layer,), "length": length}


def _kv_caches(cfg: ModelConfig, rows: Tuple[int, int], dtype,
               dev: torch.device, length) -> Params:
    """Zero K/V leaves ``(R, *rows, G, D)`` for the one attention period."""
    _check_dense(cfg)
    dtype = dtype or cfg.cache_dtype or cfg.dtype
    shape = (cfg.repeats, *rows, cfg.n_kv_heads, cfg.head_dim)
    return {"layers": ({"k": torch.zeros(shape, dtype=dtype, device=dev),
                        "v": torch.zeros(shape, dtype=dtype, device=dev)},),
            "length": length}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer(tree, r: int):
    """Layer ``r``'s view of a tree of stacked leaves."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    if isinstance(tree, QuantizedLinearParams):
        return QuantizedLinearParams(*(None if f is None else f[r]
                                       for f in tree))
    return tree[r]


def _apply_block(cfg: ModelConfig, p: Params, x, positions, cache, quant,
                 chunk_valid=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out, new_kv = attention(p, h, positions, cfg, cache=cache, quant=quant,
                            chunk_valid=chunk_valid)
    x = x + out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(p["mlp"], h2, quant=quant), new_kv


def forward(cfg: ModelConfig, params: Params, *, tokens: torch.Tensor,
            caches: Optional[Params] = None, quant=False,
            return_stats: bool = False,
            valid_len: Optional[torch.Tensor] = None,
            chunk_valid: Optional[torch.Tensor] = None,
            page_table: Optional[torch.Tensor] = None):
    """Returns ``(logits, new_caches)``; ``caches`` enables prefill/decode
    (the cache tensors are written in place).

    ``caches["length"]`` is an int (whole batch) or a ``(B,)`` int32
    tensor (per-slot, continuous batching): positions, writes and masks
    follow each row's own length.  ``valid_len`` (``(B,)``, bucketed
    prefill) marks right-padding; attention needs no mask for it (pads sit
    causally after every real token), so the dense decoder only checks it
    (the reference masks SSM state with it).  ``chunk_valid`` (``(B,)``,
    chunked prefill) makes ``tokens`` one right-padded mid-prompt chunk per
    row: only real rows are written, queries attend over the cache, and
    each row's length advances by its ``chunk_valid`` (0 leaves the row's
    cache as it was).  ``page_table`` (``(B, n_blocks)`` int32) switches
    the attention caches to the paged pool of :func:`init_paged_pool`
    (dense or log2-quantized, by the leaves the pool holds).

    ``quant`` (bool | QuantCtx) routes the 7 projections of every layer
    through the QeiHaN path.  With ``return_stats=True`` a third element
    holds the weight-plane traffic summed over every quantized projection:
    ``plane_fetched``, ``plane_total``, ``plane_traffic_fraction`` (tile
    granular) and ``element_traffic_fraction`` (ASIC bank model); zeros on
    the float path.
    """
    _check_dense(cfg)
    if valid_len is not None and chunk_valid is not None:
        raise ValueError("pass either valid_len (bucketed prefill) or "
                         "chunk_valid (chunked prefill), not both")
    if chunk_valid is not None and caches is None:
        raise ValueError("chunk_valid requires caches: a chunk appends to "
                         "resident earlier chunks")
    ctx = as_quant_ctx(quant)
    x = params["embed"][tokens]
    b, s, _ = x.shape
    base = caches["length"] if caches is not None else 0
    ar = torch.arange(s, dtype=torch.int32, device=x.device)
    if torch.is_tensor(base) and base.dim() == 1:      # per-slot lengths
        positions = base[:, None] + ar[None]
    else:
        positions = (base + ar).expand(b, s)
    block = params["blocks"][0]
    layer_cache = caches["layers"][0] if caches is not None else None
    traffic = []
    for r in range(cfg.repeats):
        # the collect list lives for one layer, like the reference's
        # per-period scan body; its per-layer sums stack over repeats
        bctx = None if ctx is None else dataclasses.replace(
            ctx, collect=[] if return_stats else None)
        if caches is None:
            kv = None
        elif page_table is not None and "k_codes" in layer_cache:
            kv = QuantPagedKVCache(
                **{f: layer_cache[f][r]
                   for f in QuantPagedKVCache._fields[:6]},
                page_table=page_table, length=base)
        elif page_table is not None:
            kv = PagedKVCache(k=layer_cache["k"][r], v=layer_cache["v"][r],
                              page_table=page_table, length=base)
        else:
            kv = KVCache(k=layer_cache["k"][r], v=layer_cache["v"][r],
                         length=base)
        x, _ = _apply_block(cfg, _layer(block, r), x, positions, kv, bctx,
                            chunk_valid=chunk_valid)
        if return_stats:
            coll = bctx.collect if bctx is not None else []
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            traffic.append([sum((c[j] for c in coll), zero)
                            for j in range(4)])
    new_caches = None
    if caches is not None:
        new_caches = {"layers": caches["layers"],
                      "length": base + (s if chunk_valid is None
                                        else chunk_valid)}

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, head.to(x.dtype))
    if not return_stats:
        return logits, new_caches
    tile_f, tile_t, el_f, el_t = (torch.stack([t[j] for t in traffic]).sum()
                                  for j in range(4))
    stats = {"plane_fetched": tile_f, "plane_total": tile_t,
             "plane_traffic_fraction": tile_f / torch.clamp(tile_t, min=1.0),
             "element_traffic_fraction": el_f / torch.clamp(el_t, min=1.0)}
    return logits, new_caches, stats
