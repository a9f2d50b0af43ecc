"""Architecture registry of the port: smollm-135m, mamba2-780m and the
three MoE configurations (deepseek-moe-16b, jamba-v0.1-52b,
phi3.5-moe-42b) so far.

``get_config(name)`` returns the published configuration, ``get_smoke``
the reduced one the CPU tests use.
"""

from __future__ import annotations

import importlib

from repro_torch.models.model import ModelConfig

ALIASES = {"smollm-135m": "smollm_135m", "smollm_135m": "smollm_135m",
           "mamba2-780m": "mamba2_780m", "mamba2_780m": "mamba2_780m",
           "deepseek-moe-16b": "deepseek_moe_16b",
           "deepseek_moe_16b": "deepseek_moe_16b",
           "jamba-v0.1-52b": "jamba_v01_52b", "jamba_v01_52b": "jamba_v01_52b",
           "phi3.5-moe-42b": "phi35_moe_42b", "phi35_moe_42b": "phi35_moe_42b"}


def _module(name: str):
    if name not in ALIASES:
        raise KeyError(f"{name!r} is not ported; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{ALIASES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE
