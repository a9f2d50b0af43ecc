"""PyTorch + CUDA port of the QeiHaN reproduction, for one NVIDIA H100.

Mirrors ``src/repro/`` module for module (``core/``, ``kernels/<name>/``,
``models/``, ``serving/``, ``configs/``, ``launch/``) and imports nothing of
it, nor JAX: the JAX package is the reference each module is tested against
(``tests/test_torch_*.py``).  Plain tensor code is PyTorch; each Pallas
kernel of the reference is a CUDA C++ kernel for ``sm_90a`` under
``kernels/<name>/csrc/``.

Entry points that create tensors take ``device=None``, which means the
card; they raise rather than fall back to the CPU when CUDA is absent.
Pass ``device="cpu"`` explicitly to run the plain-PyTorch versions on the
host (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run the "
            "plain PyTorch path on the host")
    return dev
