"""Modality frontend stubs (PyTorch counterpart of
``repro.models.frontends``).

- audio (seamless): the mel-spectrogram and conv feature extractor are not
  built; the encoder takes precomputed frame embeddings (batch, frames,
  d_model), drawn here from an explicit generator.
- vlm (chameleon): early fusion; images arrive as ordinary token ids in
  the shared vocabulary, so there is nothing to stub.

The reference draws its frames with ``jax.random``, which the port does not
reproduce: parity tests give both packages the same numpy frames.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.layers import torch_dtype


def audio_frame_specs(cfg: ModelConfig,
                      shape: InputShape) -> Tuple[Tuple[int, int, int],
                                                  torch.dtype]:
    """The (shape, dtype) of the encoder's input for ``shape``: one frame
    per ``cfg.encoder_frames_ratio`` tokens, at least one."""
    frames = max(1, shape.seq_len // cfg.encoder_frames_ratio)
    return (shape.global_batch, frames, cfg.d_model), torch_dtype(cfg.dtype)


def synth_audio_frames(generator: torch.Generator, cfg: ModelConfig,
                       batch: int, frames: int) -> torch.Tensor:
    """Standard normal frame embeddings (batch, frames, d_model) in the
    config's dtype, drawn from ``generator`` on its device."""
    return torch.randn((batch, frames, cfg.d_model), generator=generator,
                       device=generator.device).to(torch_dtype(cfg.dtype))
