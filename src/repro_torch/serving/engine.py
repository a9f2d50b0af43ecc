"""Serving layer: prefill and single-token decode steps, and the
autoregressive generation loop (port of the one-shot path of
``src/repro/serving/engine.py``).

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
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.core.shiftadd import QuantCtx, as_quant_ctx
from repro_torch.models.model import ModelConfig, forward, init_caches

QuantFlag = Union[bool, QuantCtx]


def make_prefill_step(cfg: ModelConfig, quant: QuantFlag = False):
    """(params, batch, caches) -> (last-token logits, caches)."""
    ctx = as_quant_ctx(quant)

    def prefill_step(params, batch, caches):
        logits, caches = forward(cfg, params, tokens=batch["tokens"],
                                 caches=caches, quant=ctx)
        return logits[:, -1], caches
    return prefill_step


def make_serve_step(cfg: ModelConfig, quant: QuantFlag = False,
                    with_stats: bool = False):
    """(params, caches, token (B, 1)) -> (logits, caches[, stats]): one new
    token against a pre-filled cache."""
    ctx = as_quant_ctx(quant)

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
