"""Attach the QeiHaN representation to a model's projections (port of
``src/repro/models/quantize.py``).

Every attention ``wq/wk/wv/wo``, mamba ``wz/wx/out_proj``, dense MLP and
shared-expert ``gate/up/down`` leaf gets a ``QuantizedLinearParams``
under ``<name>_q``, stacked over repeats like the float leaf, which stays
beside it.  The mamba ``wb/wc/wdt`` projections, the MoE router and the
routed experts stay float, as in the reference.
``pack=True`` stores the planes packed 8-to-a-byte along K (the
int8-footprint deploy format).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.bitplane import pack_planes
from repro_torch.core.shiftadd import (QuantizedLinearParams,
                                       quantized_linear_init)
from repro_torch.models.model import ModelConfig, _check_kinds, base_kind

_ATTN_PROJ = ("wq", "wk", "wv", "wo")
_MLP_PROJ = ("gate", "up", "down")
_MAMBA_PROJ = ("wz", "wx", "out_proj")


def _quantize_stacked(w: torch.Tensor, act_scale: float = 1.0,
                      pack: bool = False) -> QuantizedLinearParams:
    """w: (R, K, N) stacked over repeats -> stacked quant params."""
    layers = []
    for m in w:
        q = quantized_linear_init(m, act_scale=act_scale)
        if pack:
            q = q._replace(planes=pack_planes(q.planes, axis=0))
        layers.append(q)
    return QuantizedLinearParams(
        planes=torch.stack([q.planes for q in layers]),
        w_scale=torch.stack([q.w_scale for q in layers]),
        act_scale=torch.stack([q.act_scale for q in layers]),
        bias=None)


def _quantize_mlp(mlp: Dict[str, Any], act_scale: float,
                  pack: bool) -> Dict[str, Any]:
    return {**mlp, **{name + "_q": _quantize_stacked(mlp[name], act_scale,
                                                     pack)
                      for name in _MLP_PROJ}}


def quantize_model_params(cfg: ModelConfig, params: Dict[str, Any],
                          act_scale: float = 1.0,
                          pack: bool = False) -> Dict[str, Any]:
    _check_kinds(cfg)
    blocks = []
    for kind, block in zip(cfg.pattern, params["blocks"]):
        blk = dict(block)
        names = _ATTN_PROJ if base_kind(kind) == "attn" else _MAMBA_PROJ
        for name in names:
            blk[name + "_q"] = _quantize_stacked(blk[name], act_scale, pack)
        if "mlp" in blk:
            mlp = blk["mlp"]
            if "experts" not in mlp:                # dense MLP
                mlp = _quantize_mlp(mlp, act_scale, pack)
            if "shared" in mlp:
                mlp = dict(mlp, shared=_quantize_mlp(mlp["shared"],
                                                     act_scale, pack))
            blk["mlp"] = mlp
        blocks.append(blk)
    out = dict(params)
    out["blocks"] = tuple(blocks)
    return out
