"""Attach the QeiHaN representation to a model's projections (port of
``src/repro/models/quantize.py``).

Every attention ``wq/wk/wv/wo``, mamba ``wz/wx/out_proj``, dense MLP and
shared-expert ``gate/up/down`` leaf gets a ``QuantizedLinearParams``
under ``<name>_q``, stacked over repeats like the float leaf, which stays
beside it unless ``drop_float=True``.  The mamba ``wb/wc/wdt``
projections, the MoE router, the routed experts and the vision stub's
``img_proj`` stay float, as in the reference.  ``pack=True`` stores the
planes packed 8-to-a-byte along K (the int8-footprint deploy format).
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
    """w: (R, K, N) stacked over repeats -> stacked quant params, one
    repeat at a time into the stacked leaves (only one repeat's unpacked
    planes are ever temporaries)."""
    out = None
    for i, m in enumerate(w):
        q = quantized_linear_init(m, act_scale=act_scale)
        if pack:
            q = q._replace(planes=pack_planes(q.planes, axis=0))
        if out is None:
            out = [t.new_empty((w.shape[0], *t.shape))
                   for t in (q.planes, q.w_scale, q.act_scale)]
        for dst, t in zip(out, (q.planes, q.w_scale, q.act_scale)):
            dst[i] = t
    return QuantizedLinearParams(*out, bias=None)


def quantize_model_params(cfg: ModelConfig, params: Dict[str, Any],
                          act_scale: float = 1.0, drop_float: bool = False,
                          pack: bool = False) -> Dict[str, Any]:
    """A new params tree with ``<name>_q`` beside every eligible
    projection.

    ``drop_float=True`` replaces each quantized projection's float weight
    with the reference's placeholder, zeros ``(R, 1)`` in the io dtype:
    the deployment where only the bit-plane representation is resident.
    Unlike the reference, which cannot free its input, the call then also
    puts the placeholder into the CALLER's tree (``params``' block and MLP
    dicts) as soon as that leaf's planes exist, so the float weights are
    freed as the call goes unless something else holds them; the peak is
    the float model plus one leaf's planes and one repeat's unpacked
    temporaries.  With ``drop_float=False`` the input is left as it was.
    A float forward on a dropped tree raises (``models.layers.dense``).
    """
    _check_kinds(cfg)

    def quantize(src: Dict[str, Any], dst: Dict[str, Any], names) -> None:
        for name in names:
            if name not in src:
                continue
            dst[name + "_q"] = _quantize_stacked(src[name], act_scale, pack)
            if drop_float:
                ph = torch.zeros((cfg.repeats, 1), dtype=cfg.dtype,
                                 device=src[name].device)
                src[name] = dst[name] = ph

    blocks = []
    for kind, block in zip(cfg.pattern, params["blocks"]):
        blk = dict(block)
        quantize(block, blk, _ATTN_PROJ if base_kind(kind) == "attn"
                 else _MAMBA_PROJ)
        if "mlp" in blk:
            mlp_in = block["mlp"]
            mlp = blk["mlp"] = dict(mlp_in)
            if "experts" not in mlp:                # dense MLP
                quantize(mlp_in, mlp, _MLP_PROJ)
            if "shared" in mlp:
                mlp["shared"] = dict(mlp_in["shared"])
                quantize(mlp_in["shared"], mlp["shared"], _MLP_PROJ)
        blocks.append(blk)
    out = dict(params)
    out["blocks"] = tuple(blocks)
    return out
