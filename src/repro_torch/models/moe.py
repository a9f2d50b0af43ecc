"""Mixture-of-Experts: sort-based capacity dispatch (port of the local path
of ``src/repro/models/moe.py``).

Top-k routing in f32, a stable sort of the token slots by expert, the
slots that fit an expert's capacity gathered into an ``(E, C, d)``
buffer, every expert's SwiGLU over its buffer as stacked products, and
each token's outputs weighted by its gates and summed.  Shared experts
(DeepSeekMoE) run densely on every token beside the routed path, and
through the QeiHaN path when quantized; routed experts and the router
stay float, as in the reference.

Plain PyTorch: the reference computes MoE in ``jnp`` outside any Pallas
kernel.  Three points keep the port on the reference's numbers and its
graph replays bit-equal to eager runs:

* **Ties.** ``jax.lax.top_k`` takes the lower expert index where logits
  tie; ``torch.topk`` promises no order, so the router takes the first
  ``k`` of a stable descending sort.
* **Capacity** is a Python int from the call's row count ``g`` (every row:
  pad rows of a bucketed prefill and inactive slots of a scheduler tick
  too), so the same rows compete for an expert as in the reference, and
  nothing syncs with the host.
* **The combine** is the reference's scatter-add ``zeros.at[slot_token[
  order]].add(slot_out)``, which XLA applies one update at a time in
  ``order``.  The port adds each token's ``k`` slot outputs in that order
  from a zero row in the io dtype, through a gather: no atomic
  accumulation (``index_add_`` on CUDA), whose order is not fixed.

The reference's expert-parallel ``shard_map`` path (``_route_ep``) is not
ported: the port runs on one card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import swiglu


def topk_routing(router_w: torch.Tensor, x2d: torch.Tensor, n_experts: int,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d: (G, d) -> gates (G, k) f32, ids (G, k) int32; ties go to the
    lower expert index."""
    logits = torch.matmul(x2d.float(), router_w.float())       # (G, E)
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :k], dim=-1)
    return gates, ids[:, :k].to(torch.int32)


def _dispatch_tables(ids: torch.Tensor, n_experts: int,
                     capacity: int) -> Tuple[torch.Tensor, ...]:
    """Sort-based slot -> (expert, position) mapping with capacity drops.

    Returns int64 ``order`` (sorts slots expert-major, stable), int64
    ``dest`` (the row in the flattened ``(E*C)`` buffer; dropped ->
    ``E*C``) and bool ``keep``."""
    gk = ids.shape[0]
    ids = ids.long()
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    starts = torch.searchsorted(
        sorted_ids, torch.arange(n_experts, device=ids.device), side="left")
    pos = torch.arange(gk, device=ids.device) - starts[sorted_ids]
    keep = pos < capacity
    dest = torch.where(keep, sorted_ids * capacity + pos,
                       n_experts * capacity)
    return order, dest, keep


def _expert_ffn(buf: torch.Tensor, experts, dtype) -> torch.Tensor:
    """Every expert's SwiGLU over its ``(E, C, d)`` capacity buffer."""
    hg = torch.bmm(buf, experts["gate"].to(dtype))
    hu = torch.bmm(buf, experts["up"].to(dtype))
    h = F.silu(hg.float()).to(dtype) * hu
    return torch.bmm(h, experts["down"].to(dtype))


def _combine(slot_out: torch.Tensor, order: torch.Tensor, g: int,
             k: int) -> torch.Tensor:
    """``zeros((g, d)).at[slot_token[order]].add(slot_out)`` as XLA applies
    it: each token's ``k`` rows of ``slot_out`` (indexed by position in
    ``order``) added one at a time in position order, from a zero row."""
    gk = order.shape[0]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(gk, device=order.device))
    pos = torch.sort(inv.view(g, k), dim=1).values
    y = slot_out.new_zeros((g, slot_out.shape[1]))
    for j in range(k):
        y = y + slot_out[pos[:, j]]
    return y


def _route_local(p, x2d: torch.Tensor, cfg) -> torch.Tensor:
    g, d = x2d.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    capacity = min(int(g * k / e * cfg.capacity_factor) + 1, g)

    gates, ids = topk_routing(p["router"], x2d, e, k)
    flat_gates = gates.reshape(-1)
    slot_token = torch.arange(g * k, device=x2d.device) // k

    order, dest, keep = _dispatch_tables(ids.reshape(-1), e, capacity)
    xin = x2d[slot_token[order]]
    # the last row takes every dropped slot (colliding writes) and is cut
    buf = x2d.new_zeros((e * capacity + 1, d)).index_copy_(0, dest, xin)
    out_buf = _expert_ffn(buf[:-1].view(e, capacity, d), p["experts"],
                          x2d.dtype)

    flat_out = out_buf.reshape(e * capacity, d)
    safe = torch.clamp(dest, max=e * capacity - 1)
    slot_out = torch.where(keep[:, None], flat_out[safe], 0.0)
    slot_out = slot_out * flat_gates[order][:, None].to(x2d.dtype)
    return _combine(slot_out, order, g, k)


def moe_apply(p, x: torch.Tensor, cfg, quant=False) -> torch.Tensor:
    """p: ``router`` (d, E) f32; ``experts`` {'gate','up','down'} stacked
    (E, ...); optional ``shared`` SwiGLU params (``*_q`` when quantized).
    x: (B, S, d); all B*S rows are routed together."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    y2d = _route_local(p, x2d, cfg)
    if "shared" in p:
        y2d = y2d + swiglu(p["shared"], x2d, quant=quant)
    return y2d.reshape(b, s, d)
