"""Decoder models (port of ``src/repro/models/model.py``: the ``attn``,
``mamba``, ``attn_moe`` and ``mamba_moe`` block kinds and the audio and
vision frontend stubs).

A model is a periodic ``pattern`` of block kinds repeated ``n_layers /
len(pattern)`` times.  Parameters keep the reference's layout: one block
dict per pattern position whose leaves are stacked over the ``R`` repeats
(leading dim), weights ``(K, N)``.  Where the reference scans over
repeats, :func:`forward` runs a Python loop over the repeats with the
period unrolled inside, on layer views of the stacked leaves.  Caches are
one tree per pattern position and are updated in place: an attention
position holds ``(R, B, max_len, G, D)`` K/V (the paged slot pool of
:func:`init_paged_pool`: ``(R, n_pages, page_len, G, D)``, or with
``kv_quant`` packed log2 codes, per-page scales and a tail ring); a mamba
position holds its per-slot recurrent state ``ssm (R, B, H, P, N)`` f32
and conv window ``conv (R, B, W-1, conv_dim)``, dense even in a paged
pool (a recurrence has no per-position rows to page).  A ``*_moe`` kind
is its base kind with a Mixture-of-Experts MLP (``models/moe.py``).
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
from repro_torch.models.layers import dense, rms_norm, swiglu
from repro_torch.models.moe import moe_apply
from repro_torch.models.ssd import (SSMState, mamba2_block,
                                    mamba2_init_state, write_rows_)

Params = Dict[str, Any]


@dataclass(frozen=True)
class ModelConfig:
    """The reference's ``ModelConfig`` without its training-only
    ``remat``, with torch dtypes.

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
    qk_norm: bool = False
    qkv_bias: bool = False
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
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssd_chunk: int = 256
    # frontends
    frontend: str = "none"            # none | audio_stub | vision_stub
    n_image_tokens: int = 0
    sub_quadratic: bool = False

    @property
    def repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.n_layers} layers not divisible by period {len(self.pattern)}"
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


PORTED_KINDS = ("attn", "mamba", "attn_moe", "mamba_moe")


def base_kind(kind: str) -> str:
    """``attn`` or ``mamba``: the mixer of a block kind, as the reference
    splits it (``attn_moe`` -> ``attn``)."""
    return kind.split("_")[0]


def _check_kinds(cfg: ModelConfig) -> None:
    """Raise for a pattern with a block kind the port does not serve."""
    bad = [k for k in cfg.pattern if k not in PORTED_KINDS]
    if bad:
        raise NotImplementedError(f"pattern {cfg.pattern}: block kinds {bad} "
                                  f"are not ported (ported: {PORTED_KINDS})")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _normal(shape, gen: Optional[torch.Generator], dev: torch.device,
            scale: float, dtype) -> torch.Tensor:
    if dev.type == "meta":                  # shapes only (param_count)
        return torch.empty(shape, dtype=dtype, device=dev)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(device=dev, dtype=dtype)


def _stacked_normal(shape, gen: Optional[torch.Generator],
                    dev: torch.device, scale: float, dtype) -> torch.Tensor:
    """A leaf stacked over repeats, drawn one repeat at a time into the
    ``dtype`` leaf: the f32 draw of a whole stacked leaf would be twice
    its bf16 size (33.6 GB for qwen3-32b's ``gate``)."""
    out = torch.empty(shape, dtype=dtype, device=dev)
    if dev.type != "meta":
        for i in range(shape[0]):
            out[i] = _normal(shape[1:], gen, dev, scale, dtype)
    return out


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator,
                dev: torch.device) -> Params:
    """One pattern position's block, its leaves stacked over repeats."""
    dt, r, d = cfg.dtype, cfg.repeats, cfg.d_model

    def proj(k, n):
        return _stacked_normal((r, k, n), gen, dev, 1.0 / k ** 0.5, dt)

    def const(shape, value, dtype=dt):
        return torch.full((r, *shape), value, dtype=dtype, device=dev)

    if base_kind(kind) == "attn":
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        block = {"ln1": const((d,), 1.0), "wq": proj(d, h * hd),
                 "wk": proj(d, hkv * hd), "wv": proj(d, hkv * hd),
                 "wo": proj(h * hd, d)}
        if cfg.qkv_bias:
            block.update(bq=const((h * hd,), 0.0), bk=const((hkv * hd,), 0.0),
                         bv=const((hkv * hd,), 0.0))
        if cfg.qk_norm:
            block.update(q_norm=const((hd,), 1.0), k_norm=const((hd,), 1.0))
    else:
        h, n, di, w = (cfg.ssm_heads, cfg.ssm_state, cfg.d_inner,
                       cfg.conv_width)

        def conv(c):
            return _normal((r, w, c), gen, dev, 0.2, dt)

        block = {"ln1": const((d,), 1.0),
                 "wz": proj(d, di), "wx": proj(d, di), "wb": proj(d, n),
                 "wc": proj(d, n), "wdt": proj(d, h),
                 "conv_wx": conv(di), "conv_bx": const((di,), 0.0),
                 "conv_wb": conv(n), "conv_bb": const((n,), 0.0),
                 "conv_wc": conv(n), "conv_bc": const((n,), 0.0),
                 "dt_bias": const((h,), 0.0, torch.float32),
                 "a_log": const((h,), 0.0, torch.float32),      # A = -1
                 "d_skip": const((h,), 1.0, torch.float32),
                 "norm": const((di,), 1.0),
                 "out_proj": proj(di, d)}
    if kind.endswith("_moe"):
        block["ln2"] = const((d,), 1.0)
        block["mlp"] = _init_moe(cfg, gen, dev, proj)
    elif base_kind(kind) == "attn" or cfg.d_ff:
        ff = cfg.d_ff
        block["ln2"] = const((d,), 1.0)
        block["mlp"] = {"gate": proj(d, ff), "up": proj(d, ff),
                        "down": proj(ff, d)}
    return block


def _init_moe(cfg: ModelConfig, gen, dev: torch.device, proj) -> Params:
    """A MoE MLP stacked over repeats: the f32 router (d, E), N(0, 0.02);
    routed experts (E, d, ffe) and (E, ffe, d) drawn as the reference's
    ``dense_init(E*K, N)`` reshaped (scale ``1/sqrt(E*K)``); shared
    experts a dense MLP of width ``ffe * n_shared_experts``."""
    dt, r, d, e = cfg.dtype, cfg.repeats, cfg.d_model, cfg.n_experts
    ffe = cfg.moe_d_ff or cfg.d_ff

    def experts(k, n):
        return _stacked_normal((r, e, k, n), gen, dev, 1.0 / (e * k) ** 0.5,
                               dt)

    mlp = {"router": _normal((r, d, e), gen, dev, 0.02, torch.float32),
           "experts": {"gate": experts(d, ffe), "up": experts(d, ffe),
                       "down": experts(ffe, d)}}
    if cfg.n_shared_experts:
        ffs = ffe * cfg.n_shared_experts
        mlp["shared"] = {"gate": proj(d, ffs), "up": proj(d, ffs),
                         "down": proj(ffs, d)}
    return mlp


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random weights with the reference's shapes and scales: embeddings
    N(0, 0.02), projections N(0, 1/sqrt(K)) (stacked ones drawn a repeat
    at a time), conv weights N(0, 0.2^2), norms (``q_norm``/``k_norm``
    with ``qk_norm``) and ``d_skip`` 1, biases (``bq/bk/bv`` with
    ``qkv_bias``), ``dt_bias`` and ``a_log`` 0; a ``*_moe`` block's MLP as
    :func:`_init_moe`; a ``vision_stub`` model's ``img_proj`` (d, d)
    drawn last.  A mamba block has a dense MLP only when ``d_ff`` is set.
    ``generator`` defaults to one seeded with 0 on ``device``;
    ``device="meta"`` gives the shapes alone."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    gen = generator or (None if dev.type == "meta" else
                        torch.Generator(device=dev).manual_seed(0))
    blocks = tuple(_init_block(cfg, kind, gen, dev) for kind in cfg.pattern)
    params: Params = {
        "embed": _normal((cfg.vocab_size, cfg.d_model), gen, dev, 0.02,
                         cfg.dtype),
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal((cfg.d_model, cfg.vocab_size), gen, dev,
                                    0.02, cfg.dtype)
    if cfg.frontend == "vision_stub":
        params["img_proj"] = _normal((cfg.d_model, cfg.d_model), gen, dev,
                                     1.0 / cfg.d_model ** 0.5, cfg.dtype)
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _ssm_leaves(cfg: ModelConfig, batch: int, dtype,
                dev: torch.device) -> Params:
    """A mamba position's zero per-slot state, stacked over repeats:
    ``ssm (R, B, H, P, N)`` f32 and ``conv (R, B, W-1, conv_dim)`` in
    ``dtype``."""
    st = mamba2_init_state(cfg.repeats * batch, cfg, dtype, dev)
    return {k: t.unflatten(0, (cfg.repeats, batch))
            for k, t in st._asdict().items()}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                device=None, per_slot: bool = False) -> Params:
    """Zero caches, one tree per pattern position: stacked K/V ``(R, B,
    max_len, G, D)`` for ``attn``, the recurrent state for ``mamba``.
    ``length`` is the int 0, or with ``per_slot=True`` a ``(batch,)``
    int32 tensor, one valid length per row (the continuous-batching slot
    pool)."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.cache_dtype or cfg.dtype
    shape = (cfg.repeats, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    layers = tuple(
        {"k": torch.zeros(shape, dtype=dtype, device=dev),
         "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if base_kind(kind) == "attn" else _ssm_leaves(cfg, batch, dtype, dev)
        for kind in cfg.pattern)
    length = (torch.zeros((batch,), dtype=torch.int32, device=dev)
              if per_slot else 0)
    return {"layers": layers, "length": length}


def init_paged_pool(cfg: ModelConfig, batch: int, max_len: int,
                    n_pages: int, page_len: int, dtype=None,
                    device=None) -> Params:
    """Paged slot-pool caches: attention K/V in a shared page pool
    ``(R, n_pages, page_len, G, D)`` indexed through host-built per-slot
    page tables (page 0 is the trash page, ``serving.kvpool``); per-slot
    ``(batch,)`` lengths.  ``max_len`` must be a multiple of ``page_len``
    so a slot's gathered view has the dense slab's shape.  A mamba
    position keeps the dense per-slot recurrent state of
    :func:`init_caches`.

    ``cfg.kv_quant=True`` stores the attention pool as packed log2 wire
    codes ``{k,v}_codes (R, n_pages, page_len, G, D)``
    (``code_dtype(kv_bits)``), per-(page, head) power-of-two scale
    exponents ``{k,v}_scale (R, n_pages, G)`` int32, and a dense per-slot
    tail ring ``{k,v}_tail (R, batch, 2*page_len + 1, G, D)`` in the cache
    dtype holding each slot's newest two pages (row ``2*page_len`` is the
    junk bin)."""
    if max_len % page_len:
        raise ValueError(f"max_len={max_len} must be a multiple of "
                         f"page_len={page_len}")
    _check_kinds(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.cache_dtype or cfg.dtype
    r, g, d = cfg.repeats, cfg.n_kv_heads, cfg.head_dim
    layers = []
    for kind in cfg.pattern:
        if base_kind(kind) != "attn":
            layers.append(_ssm_leaves(cfg, batch, dtype, dev))
            continue
        layer = {}
        if not cfg.kv_quant:
            for k in ("k", "v"):
                layer[k] = torch.zeros((r, n_pages, page_len, g, d),
                                       dtype=dtype, device=dev)
            layers.append(layer)
            continue
        ct = code_dtype(cfg.kv_bits)
        for k in ("k", "v"):
            layer[f"{k}_codes"] = torch.zeros((r, n_pages, page_len, g, d),
                                              dtype=ct, device=dev)
            layer[f"{k}_scale"] = torch.zeros((r, n_pages, g),
                                              dtype=torch.int32, device=dev)
            layer[f"{k}_tail"] = torch.zeros(
                (r, batch, 2 * page_len + 1, g, d), dtype=dtype, device=dev)
        layers.append(layer)
    return {"layers": tuple(layers),
            "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}


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


def _unbind(tree, n: int) -> list:
    """The ``n`` layer views :func:`_layer` gives, each stacked leaf split
    once: autograd then stacks the layers' gradients in one op, where
    ``n`` selects would each write a zero leaf and add it."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    if isinstance(tree, QuantizedLinearParams):
        fields = [(None,) * n if f is None else f.unbind(0) for f in tree]
        return [QuantizedLinearParams(*(f[r] for f in fields))
                for r in range(n)]
    return list(tree.unbind(0))


def _layer_cache(c: Params, r: int, page_table, length):
    """Layer ``r``'s cache of one pattern position: a K/V record for
    attention (dense, paged or log2-quantized paged, by the leaves the
    pool holds), the state views ``{"ssm", "conv"}`` for mamba."""
    if "ssm" in c:
        return {"ssm": c["ssm"][r], "conv": c["conv"][r]}
    if page_table is not None and "k_codes" in c:
        return QuantPagedKVCache(
            **{f: c[f][r] for f in QuantPagedKVCache._fields[:6]},
            page_table=page_table, length=length)
    if page_table is not None:
        return PagedKVCache(k=c["k"][r], v=c["v"][r], page_table=page_table,
                            length=length)
    return KVCache(k=c["k"][r], v=c["v"][r], length=length)


def _apply_block(cfg: ModelConfig, kind: str, p: Params, x, positions,
                 cache, quant, valid_len=None, chunk_valid=None,
                 state_rows=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if base_kind(kind) == "attn":
        out, _ = attention(p, h, positions, cfg, cache=cache, quant=quant,
                           chunk_valid=chunk_valid)
    else:
        # a chunk's per-row valid count doubles as the SSM pad mask (pad
        # tokens get dt = 0), the same masking bucketed prefill uses
        st = None if cache is None else SSMState(ssm=cache["ssm"],
                                                 conv=cache["conv"])
        out, new = mamba2_block(
            p, h, cfg, state=st, quant=quant,
            valid_len=chunk_valid if chunk_valid is not None else valid_len)
        if new is not None:
            write_rows_(cache["ssm"], new.ssm, state_rows)
            write_rows_(cache["conv"], new.conv, state_rows)
    x = x + out
    if "mlp" in p:
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind.endswith("_moe"):
            x = x + moe_apply(p["mlp"], h2, cfg, quant=quant)
        else:
            x = x + swiglu(p["mlp"], h2, quant=quant)
    return x


def forward(cfg: ModelConfig, params: Params, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            image_embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Params] = None, quant=False,
            return_stats: bool = False,
            valid_len: Optional[torch.Tensor] = None,
            chunk_valid: Optional[torch.Tensor] = None,
            page_table: Optional[torch.Tensor] = None,
            state_rows: Optional[torch.Tensor] = None):
    """Returns ``(logits, new_caches)``; ``caches`` enables prefill/decode
    (the cache tensors are written in place).

    The input rows are ``params["embed"][tokens]``, or ``embeds`` (B, S,
    d) cast to the io dtype (the audio stub's frame embeddings); with
    ``image_embeds`` (B, n_img, d), ``img_proj`` of them (a float
    projection) is prepended along the sequence (the vision stub), and
    positions and cache lengths count those rows.  ``positions`` ((B, S)
    int) overrides the positions derived from the cache lengths (rotary
    angles and causal masks); the cache writes still land at the lengths.

    ``caches["length"]`` is an int (whole batch) or a ``(B,)`` int32
    tensor (per-slot, continuous batching): positions, writes and masks
    follow each row's own length.  ``valid_len`` (``(B,)``, bucketed
    prefill) marks rows ``>= valid_len[b]`` of the input as right-padding:
    SSM state and conv updates are masked so pad tokens neither decay nor
    feed the recurrent state (attention needs no mask: pads sit causally
    after every real token).  ``chunk_valid`` (``(B,)``, chunked prefill)
    makes ``tokens`` one right-padded mid-prompt chunk per row: only real
    rows are written, queries attend over the cache, the SSM path masks
    pads as ``valid_len`` does, and each row's length advances by its
    ``chunk_valid`` (0 leaves the row's cache as it was).  ``page_table``
    (``(B, n_blocks)`` int32) switches the attention caches to the paged
    pool of :func:`init_paged_pool` (dense or log2-quantized, by the
    leaves the pool holds).  ``state_rows`` (``(B,)`` bool, the port's
    own) names the rows whose SSM/conv state the call may advance; the
    others keep theirs bit for bit (the slot pool's inactive slots,
    ``serving.engine.make_slot_serve_step``): the reference selects the
    old state back after its functional forward, the port selects as it
    writes in place.

    ``quant`` (bool | QuantCtx) routes every eligible projection (attention
    ``wq wk wv wo``, dense and shared-expert MLP ``gate up down``, mamba
    ``wz wx out_proj``) through the QeiHaN path; routed experts and the
    router stay float.  A MoE block routes all ``B*S`` rows of the call
    together, so its expert capacity follows the call's shape.  With
    ``return_stats=True`` a third element holds the weight-plane traffic
    summed over every quantized projection:
    ``plane_fetched``, ``plane_total``, ``plane_traffic_fraction`` (tile
    granular) and ``element_traffic_fraction`` (ASIC bank model); zeros on
    the float path.
    """
    _check_kinds(cfg)
    if valid_len is not None and chunk_valid is not None:
        raise ValueError("pass either valid_len (bucketed prefill) or "
                         "chunk_valid (chunked prefill), not both")
    if chunk_valid is not None and caches is None:
        raise ValueError("chunk_valid requires caches: a chunk appends to "
                         "resident earlier chunks")
    ctx = as_quant_ctx(quant)
    if embeds is not None:                 # audio stub: frame embeddings
        x = embeds.to(cfg.dtype)
    else:
        x = params["embed"][tokens]
    if image_embeds is not None:           # vision stub: prepend patches
        img = dense(params["img_proj"], image_embeds.to(cfg.dtype))
        x = torch.cat([img, x], dim=1)
    b, s, _ = x.shape
    base = caches["length"] if caches is not None else 0
    if positions is None:
        ar = torch.arange(s, dtype=torch.int32, device=x.device)
        if torch.is_tensor(base) and base.dim() == 1:  # per-slot lengths
            positions = base[:, None] + ar[None]
        else:
            positions = (base + ar).expand(b, s)
    blocks = [_unbind(blk, cfg.repeats) for blk in params["blocks"]]
    traffic = []
    for r in range(cfg.repeats):
        # the collect list lives for one period, like the reference's
        # scan body; its per-period sums stack over repeats
        bctx = None if ctx is None else dataclasses.replace(
            ctx, collect=[] if return_stats else None)
        for i, kind in enumerate(cfg.pattern):
            cache = (None if caches is None else _layer_cache(
                caches["layers"][i], r, page_table, base))
            x = _apply_block(cfg, kind, blocks[i][r], x,
                             positions, cache, bctx, valid_len=valid_len,
                             chunk_valid=chunk_valid, state_rows=state_rows)
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


def next_token_loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
                    quant=False) -> torch.Tensor:
    """Causal LM loss (port of the reference's ``next_token_loss``):
    ``batch`` holds ``tokens`` or ``embeds`` (+ ``image_embeds``),
    ``labels`` and an optional ``mask``.  The mean over masked positions
    of the f32 ``logsumexp`` of the logits minus the label's logit; the
    vision stub's prepended image rows are cut from the logits.  ``quant``
    routes projections as in :func:`forward` (a float tree stays float)."""
    logits, _ = forward(cfg, params, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"),
                        image_embeds=batch.get("image_embeds"), quant=quant)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:     # vision stub's image rows
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    lab = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - lab
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _leaves(tree):
    """The tensors of a tree of dicts, tuples (named ones too) and lists."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def param_count(cfg: ModelConfig) -> Dict[str, int]:
    """Parameter counts (total, and active: routed experts scaled by
    ``experts_per_token / n_experts``) of :func:`init_params`'s tree, from
    its shapes on the meta device (nothing is allocated)."""
    tree = init_params(cfg, device="meta")
    total = sum(t.numel() for t in _leaves(tree))
    expert = sum(t.numel() for kind, blk in zip(cfg.pattern, tree["blocks"])
                 if kind.endswith("_moe")
                 for t in _leaves(blk["mlp"]["experts"]))
    if cfg.n_experts:
        active = total - expert * (1 - cfg.experts_per_token / cfg.n_experts)
    else:
        active = total
    return {"total": int(total), "active": int(active)}
