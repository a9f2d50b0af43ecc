"""Carry the JAX package's parameter tree and cache pools into the port's
tensors.

The input is the reference tree after ``jax.tree.map(np.asarray, tree)``:
dicts and tuples of numpy arrays (bfloat16 arrives as the ``ml_dtypes``
type), scan-stacked leaves ``(R, ...)``, and the quantized ``*_q`` leaves
as namedtuple-like objects read by field name.  Every leaf is carried as
it is, whatever its name: the ``qkv_bias`` and ``qk_norm`` leaves
(``bq/bk/bv``, ``q_norm/k_norm``), the vision stub's ``img_proj`` and the
``(R, 1)`` placeholders of a ``drop_float`` tree too.  The tests use it so
both frameworks compute with the same weights and start a write from the
same pool; on the card the port makes its own with ``init_params``.

:func:`paper_params_from_numpy` does the same for a paper net's flat dict
of arrays (``models/paper_nets.py``): the reference draws those weights
inside its forwards and exposes no tree, so the tests replay its draws.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.shiftadd import QuantizedLinearParams
from repro_torch.models.model import ModelConfig, _check_kinds


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(dev)


def _convert(leaf, dev: torch.device):
    if leaf is None:
        return None
    if isinstance(leaf, dict):
        return {k: _convert(v, dev) for k, v in leaf.items()}
    fields = getattr(leaf, "_fields", None)
    if fields is not None:
        if tuple(fields) != QuantizedLinearParams._fields:
            raise TypeError(f"unknown record {type(leaf).__name__}{fields}")
        return QuantizedLinearParams(*(_convert(getattr(leaf, f), dev)
                                       for f in fields))
    if isinstance(leaf, (tuple, list)):
        return tuple(_convert(v, dev) for v in leaf)
    return _tensor(leaf, dev)


def params_from_numpy(cfg: ModelConfig, tree: Any, device=None) -> Any:
    """The reference tree (numpy leaves) as the port's params on ``device``."""
    _check_kinds(cfg)
    return _convert(tree, resolve_device(device))


def paper_params_from_numpy(name: str, arrays: dict,
                            device=None) -> dict:
    """A paper net's weights and input, as numpy arrays under the keys of
    ``paper_nets.init_paper_params(name, ...)``, as tensors on ``device``."""
    from repro_torch.models.paper_nets import PAPER_ACTIVATIONS

    if name not in PAPER_ACTIVATIONS:
        raise KeyError(f"unknown paper net {name!r}")
    dev = resolve_device(device)
    return {k: _tensor(a, dev) for k, a in arrays.items()}


def pool_from_numpy(tree: Any, device=None) -> Any:
    """A reference cache pool (``{"layers": (...), "length": ...}`` with
    numpy leaves: dense or quantized pages, codes, scales, tail rings, SSM
    state and conv windows) as
    the port's tensors on ``device``."""
    return _convert(tree, resolve_device(device))
