"""Serving layer: prefill and single-token decode steps, the
autoregressive generation loop, and the slot-pool steps of continuous
batching (port of ``src/repro/serving/engine.py`` without its mesh
plumbing and SSM-state masking).

The reference compiles prefill plus every decode step into one XLA
program (``lax.scan``, or ``lax.while_loop`` with ``eos_id``); here the
same steps run eagerly in a Python loop with the same step count: the
first token comes from the prefill logits, ``max_new - 1`` decode forwards
follow, and the dead forward after the last token is skipped (its stats
slot reports zero).  :func:`reference_generate` keeps the per-token loop
that does run that last forward, as the reference does.

Quantized serving (``quant=True``) sends every projection of prefill and
decode through the two CUDA kernels (the reference's prefill uses its
plain ``"xla"`` form; both are exact, so tokens do not depend on it).

The slot-pool steps (:func:`make_slot_serve_step`, :func:`make_slot_prefill`,
:func:`make_slot_prefill_chunk`) are the device programs of
``serving/scheduler.py``: they take per-slot ``(B,)`` lengths and,
``paged=True``, a page table; the reference jits each, here each is one
eager call.  ``quant`` may be the reference's backend names (``"pallas"``,
``"xla"``): both select the CUDA kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.shiftadd import QuantCtx, as_quant_ctx
from repro_torch.models.model import ModelConfig, forward, init_caches

QuantFlag = Union[bool, str, QuantCtx]


def _quant_ctx(quant: QuantFlag):
    """bool | backend name | QuantCtx -> QuantCtx or None.  A backend name
    (the reference's ``"pallas"`` / ``"xla"``) means quantized: the port
    has one quantized path, its two CUDA kernels."""
    if isinstance(quant, str):
        return as_quant_ctx(True)
    return as_quant_ctx(quant)


def make_prefill_step(cfg: ModelConfig, quant: QuantFlag = False):
    """(params, batch, caches) -> (last-token logits, caches)."""
    ctx = _quant_ctx(quant)

    def prefill_step(params, batch, caches):
        logits, caches = forward(cfg, params, tokens=batch["tokens"],
                                 caches=caches, quant=ctx)
        return logits[:, -1], caches
    return prefill_step


def make_serve_step(cfg: ModelConfig, quant: QuantFlag = False,
                    with_stats: bool = False):
    """(params, caches, token (B, 1)) -> (logits, caches[, stats]): one new
    token against a pre-filled cache."""
    ctx = _quant_ctx(quant)

    def serve_step(params, caches, token):
        out = forward(cfg, params, tokens=token, caches=caches, quant=ctx,
                      return_stats=with_stats)
        if with_stats:
            logits, caches, stats = out
            return logits[:, -1], caches, stats
        logits, caches = out
        return logits[:, -1], caches
    return serve_step


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def make_decode_loop(cfg: ModelConfig, max_new: int, *,
                     temperature: float = 0.0, quant: QuantFlag = False,
                     eos_id: Optional[int] = None, with_stats: bool = False):
    """Build ``decode(params, caches, logits, generator) -> (tokens,
    stats)``.

    ``caches`` are pre-filled and ``logits`` is the last prompt token's
    distribution.  Returns tokens ``(B, max_new)`` int32 and, with
    ``with_stats``, per-step ``(max_new,)`` ``plane_traffic_fraction`` and
    ``element_traffic_fraction`` (entry ``i`` is the forward that consumed
    token ``i``; skipped forwards report 0), else ``None``.  With
    ``eos_id`` the loop stops once every row has emitted it; later slots
    are ``eos_id``.
    """
    step = make_serve_step(cfg, quant, with_stats=with_stats)

    def decode(params, caches, logits, generator=None):
        b = logits.shape[0]
        dev = logits.device
        toks = torch.full((b, max_new), -1 if eos_id is None else eos_id,
                          dtype=torch.int32, device=dev)
        fracs = torch.zeros((max_new, 2), dtype=torch.float32, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        for i in range(max_new):
            tok = _sample(logits, temperature, generator)
            if eos_id is not None:
                tok = torch.where(done, eos_id, tok)
                done = done | (tok == eos_id)
            toks[:, i] = tok
            # the forward after the last sampled token (or once every row
            # is done) would be dead: skip it, its stats slot stays zero
            if i + 1 >= max_new or (eos_id is not None and bool(done.all())):
                break
            out = step(params, caches, tok[:, None])
            if with_stats:
                logits, caches, stats = out
                fracs[i, 0] = stats["plane_traffic_fraction"]
                fracs[i, 1] = stats["element_traffic_fraction"]
            else:
                logits, caches = out
        if not with_stats:
            return toks, None
        return toks, {"plane_traffic_fraction": fracs[:, 0],
                      "element_traffic_fraction": fracs[:, 1]}
    return decode


def _check_inputs(params, prompt: torch.Tensor, device):
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"not on {dev}")
    return dev, prompt.to(dev)


def greedy_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                    max_new: int, *, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    quant: bool = False, eos_id: Optional[int] = None,
                    with_stats: bool = False, device=None):
    """Batched generation: prefill, then the decode loop.  Returns tokens
    ``(B, max_new)``; with ``with_stats=True``, ``(tokens, stats)``.
    ``generator`` drives temperature sampling (default: seed 0 on the
    device)."""
    if not isinstance(quant, bool):
        raise TypeError("greedy_generate takes quant as bool; build a "
                        "custom loop via make_decode_loop for a QuantCtx")
    dev, prompt = _check_inputs(params, prompt, device)
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    b, s = prompt.shape
    caches = init_caches(cfg, b, max_len=s + max_new, dtype=cfg.dtype,
                         device=dev)
    logits, caches = make_prefill_step(cfg, quant)(
        params, {"tokens": prompt}, caches)
    decode = make_decode_loop(cfg, max_new, temperature=temperature,
                              quant=quant, eos_id=eos_id,
                              with_stats=with_stats)
    toks, stats = decode(params, caches, logits, generator)
    return (toks, stats) if with_stats else toks


def reference_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                       max_new: int, *, temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       quant: bool = False, device=None) -> torch.Tensor:
    """The per-token loop with a forward after every token: the semantic
    oracle for :func:`greedy_generate`."""
    dev, prompt = _check_inputs(params, prompt, device)
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    b, s = prompt.shape
    caches = init_caches(cfg, b, max_len=s + max_new, dtype=cfg.dtype,
                         device=dev)
    prefill = make_prefill_step(cfg, quant)
    step = make_serve_step(cfg, quant)
    logits, caches = prefill(params, {"tokens": prompt}, caches)
    toks = []
    for _ in range(max_new):
        cur = _sample(logits, temperature, generator)
        toks.append(cur)
        logits, caches = step(params, caches, cur[:, None])
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# slot-pool steps (continuous batching)
# ---------------------------------------------------------------------------

def make_slot_serve_step(cfg: ModelConfig, quant: QuantFlag = False,
                         with_stats: bool = False, *, paged: bool = False):
    """``(params, caches, tokens (B, 1), active (B,)[, page_table]) ->
    (logits, caches[, stats])``: one decode step of every slot.

    Every row computes; ``active`` masks the bookkeeping: an inactive
    slot's ``length`` does not advance (its junk K/V row lands at the
    frozen length, where the next real write overwrites it).
    ``caches["length"]`` is the per-slot ``(B,)`` form.  ``paged=True``
    takes a ``page_table (B, n_blocks)`` and page-pool caches
    (``init_paged_pool``); with ``cfg.paged_attn_kernel != "off"`` the read
    walks the table in the paged-attention kernel.  With
    ``with_stats=True`` the stats are the batch-aggregate plane traffic of
    the step."""
    ctx = _quant_ctx(quant)

    def slot_step(params, caches, tokens, active, page_table=None):
        if paged and page_table is None:
            raise ValueError("a paged slot step needs a page_table")
        out = forward(cfg, params, tokens=tokens, caches=caches, quant=ctx,
                      return_stats=with_stats,
                      page_table=page_table if paged else None)
        if with_stats:
            logits, new_caches, stats = out
        else:
            logits, new_caches = out
        new_caches = {"layers": new_caches["layers"],
                      "length": torch.where(active, new_caches["length"],
                                            caches["length"])}
        if with_stats:
            return logits[:, -1], new_caches, stats
        return logits[:, -1], new_caches
    return slot_step


def _last_real(logits: torch.Tensor, n_real: torch.Tensor) -> torch.Tensor:
    """``logits (B, S, V)`` at each row's position ``n_real - 1`` (0 for
    rows with none)."""
    b, _, v = logits.shape
    idx = torch.clamp(n_real.long() - 1, min=0)[:, None, None].expand(b, 1, v)
    return torch.gather(logits, 1, idx)[:, 0]


def make_slot_prefill(cfg: ModelConfig, quant: QuantFlag = False):
    """``(params, prompt (B, bucket), true_len (B,), caches) -> (last-real
    logits (B, V), caches)``: bucketed prefill for slot admission.  The
    prompt is right-padded to its bucket; pads sit causally after every
    real token, and their junk K/V rows lie past ``length``.  The cache's
    ``length`` becomes the per-row true length."""
    ctx = _quant_ctx(quant)

    def prefill(params, prompt, true_len, caches):
        logits, caches = forward(cfg, params, tokens=prompt, caches=caches,
                                 quant=ctx, valid_len=true_len)
        caches = {"layers": caches["layers"], "length": true_len}
        return _last_real(logits, true_len), caches
    return prefill


def make_slot_prefill_chunk(cfg: ModelConfig, quant: QuantFlag = False,
                            with_stats: bool = False, *,
                            paged: bool = False):
    """``(params, pool, pool_logits, tokens (B, chunk_len), chunk_valid
    (B,), fresh (B,), finishing (B,)[, page_table]) -> (logits (B, V),
    pool[, stats])``: one prompt chunk per prefilling slot, written
    straight into the slot pool.

    Each prefilling row feeds its next ``chunk_valid[b]`` prompt tokens
    (right-padded to the fixed slab) at its current ``length``; decoding
    or free rows ride along with ``chunk_valid == 0`` and keep their cache.
    ``fresh`` rows ingest their first chunk: their length restarts at 0.
    ``finishing`` rows hold the prompt's last token: their last-real
    logits replace their row of ``pool_logits``.  ``paged=True`` takes a
    ``page_table``; a prefix-hit admission enters with ``fresh`` False and
    its length pre-set to the hit, so the chunk ingests only the suffix.
    """
    ctx = _quant_ctx(quant)

    def chunk_step(params, pool, pool_logits, tokens, chunk_valid, fresh,
                   finishing, page_table=None):
        if paged and page_table is None:
            raise ValueError("a paged chunk step needs a page_table")
        caches = {"layers": pool["layers"],
                  "length": torch.where(fresh, 0, pool["length"])}
        out = forward(cfg, params, tokens=tokens, caches=caches, quant=ctx,
                      chunk_valid=chunk_valid, return_stats=with_stats,
                      page_table=page_table if paged else None)
        if with_stats:
            logits, new_caches, stats = out
        else:
            logits, new_caches = out
        last = _last_real(logits, chunk_valid)
        new_logits = torch.where(finishing[:, None],
                                 last.to(pool_logits.dtype), pool_logits)
        if with_stats:
            return new_logits, new_caches, stats
        return new_logits, new_caches
    return chunk_step
