"""Unified model API: ``build_model(cfg)`` (PyTorch counterpart of
``repro.models.model``)."""
from __future__ import annotations

from typing import Union

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig) -> Union[DecoderLM, EncDecLM]:
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    return DecoderLM(cfg)
