"""Unified model API: ``build_model(cfg)`` (PyTorch counterpart of
``repro.models.model``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig) -> DecoderLM:
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder family is not ported yet (ROADMAP A9)")
    return DecoderLM(cfg)
