"""Bit-plane weight storage — QeiHaN paper §IV-B (Fig. 7).

Port of ``src/repro/core/bitplane.py``.  An int8 weight tensor splits into
8 ``{0,1}`` planes, plane-major (plane ``b`` holds bit ``b``), so a kernel
can fetch only the MSB planes a negative activation exponent needs: with
two's complement, ``floor(w / 2^k)`` depends only on planes ``b >= k``, so
dropping the low planes IS the arithmetic shift.  :func:`pack_planes`
packs each plane 8-to-a-byte along one axis (bit ``j`` of byte ``g`` holds
element ``8*g + j``), the int8-footprint deploy format.
"""

from __future__ import annotations

import torch

__all__ = ["to_bitplanes", "from_bitplanes", "pack_planes", "unpack_planes",
           "plane_coefficients"]

WEIGHT_BITS = 8


def to_bitplanes(q: torch.Tensor, bits: int = WEIGHT_BITS) -> torch.Tensor:
    """int8 ``(...)`` -> uint8 ``(bits, ...)`` of {0,1}; plane b = bit b."""
    if bits > 8:
        raise ValueError(f"bits={bits}: only int8 weights are ported")
    u = q.to(torch.uint8)                       # two's-complement bytes
    return torch.stack([(u >> b) & 1 for b in range(bits)])


def plane_coefficients(bits: int = WEIGHT_BITS) -> torch.Tensor:
    """Signed weight of each plane: ``[1, 2, 4, ..., -2^(bits-1)]``."""
    c = [1 << b for b in range(bits - 1)] + [-(1 << (bits - 1))]
    return torch.tensor(c, dtype=torch.int32)


def from_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_bitplanes` (returns int32 values)."""
    bits = planes.shape[0]
    coef = plane_coefficients(bits).to(planes.device)
    coef = coef.reshape((bits,) + (1,) * (planes.dim() - 1))
    return (planes.to(torch.int32) * coef).sum(dim=0, dtype=torch.int32)


def pack_planes(planes: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Pack a ``(bits, ..., K, ...)`` plane tensor 8x along ``axis``.

    ``axis`` indexes a single plane (the leading plane axis excluded); its
    length must be divisible by 8.
    """
    full_axis = axis % (planes.dim() - 1) + 1
    k = planes.shape[full_axis]
    if k % 8:
        raise ValueError(f"pack axis length {k} not divisible by 8")
    moved = torch.movedim(planes, full_axis, -1)
    grouped = moved.reshape(moved.shape[:-1] + (k // 8, 8)).to(torch.uint8)
    weights = torch.tensor([1 << j for j in range(8)], dtype=torch.uint8,
                           device=planes.device)
    packed = (grouped * weights).sum(dim=-1, dtype=torch.uint8)
    return torch.movedim(packed, -1, full_axis).contiguous()


def unpack_planes(packed: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`pack_planes`."""
    full_axis = axis % (packed.dim() - 1) + 1
    moved = torch.movedim(packed, full_axis, -1)
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (moved.unsqueeze(-1) >> shifts) & 1
    flat = bits.reshape(moved.shape[:-1] + (moved.shape[-1] * 8,))
    return torch.movedim(flat, -1, full_axis).contiguous()
