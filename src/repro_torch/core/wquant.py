"""INT8 symmetric weight quantization — QeiHaN paper Eq. 1 with ``z = 0``.

Port of ``src/repro/core/wquant.py``.  The grid is ``[-(2^(b-1)-1),
2^(b-1)-1]`` (no -128), so the bit-plane decomposition and the arithmetic
shifts are symmetric in range.  ``w / scale`` stays in float32 and
``torch.round`` rounds half to even, like ``jnp.round``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["QuantizedWeights", "quantize_weights"]


class QuantizedWeights(NamedTuple):
    """Symmetric integer weights: ``w ~= q * scale``."""

    q: torch.Tensor      # int8 (or int32 for >8-bit grids)
    scale: torch.Tensor  # f32, broadcastable against q
    bits: int


def quantize_weights(w: torch.Tensor, bits: int = 8,
                     channel_axis: Optional[int] = None) -> QuantizedWeights:
    """Symmetric uniform quantization to ``bits`` (default INT8).

    ``channel_axis`` selects per-channel scales (the output-feature axis of
    a ``(K, N)`` weight); ``None`` gives one per-tensor scale.
    """
    w = w.float()
    qmax = (1 << (bits - 1)) - 1
    if channel_axis is None:
        absmax = w.abs().amax()
    else:
        axes = tuple(a for a in range(w.dim()) if a != channel_axis % w.dim())
        absmax = w.abs().amax(dim=axes, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / qmax
    q = torch.clamp(torch.round(w / scale), -qmax, qmax)
    dtype = torch.int8 if bits <= 8 else torch.int32
    return QuantizedWeights(q=q.to(dtype), scale=scale, bits=bits)
