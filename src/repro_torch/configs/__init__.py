"""Architecture registry of the port: the reference's ten configurations
(``src/repro/configs``), each a field-for-field copy.

``get_config(name)`` returns the published configuration, ``get_smoke``
the reduced one the CPU tests use; ``name`` is a dashed id of
``ALIASES`` or a module name of ``ARCHS``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.model import ModelConfig

ARCHS: List[str] = [
    "qwen3_32b",
    "qwen25_14b",
    "smollm_135m",
    "phi4_mini_3p8b",
    "musicgen_medium",
    "phi35_moe_42b",
    "deepseek_moe_16b",
    "jamba_v01_52b",
    "mamba2_780m",
    "internvl2_26b",
]

# the reference's dashed ids, plus the short phi3.5-moe id the port's
# earlier slices used
ALIASES: Dict[str, str] = {
    "qwen3-32b": "qwen3_32b",
    "qwen2.5-14b": "qwen25_14b",
    "smollm-135m": "smollm_135m",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "musicgen-medium": "musicgen_medium",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "phi3.5-moe-42b": "phi35_moe_42b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "mamba2-780m": "mamba2_780m",
    "internvl2-26b": "internvl2_26b",
}


def _module(name: str):
    mod = ALIASES.get(name, name)
    if mod not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(ALIASES)} or {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def list_archs() -> List[str]:
    return list(ARCHS)
