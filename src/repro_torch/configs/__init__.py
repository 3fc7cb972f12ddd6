"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>`` (a copy
of ``repro.configs``, the same ids and numbers)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig, reduced

_ARCHS = {
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
}

ARCH_IDS = tuple(_ARCHS)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    return importlib.import_module(_ARCHS[arch]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
    "all_configs", "get_config", "reduced",
]
