"""Unified model API: ``build_model(cfg)`` and ``input_specs(cfg, shape)``
(PyTorch counterpart of ``repro.models.model``).

``input_specs`` returns stand-ins for every model input of a given (arch,
input-shape) pair: tensors on the ``meta`` device, which carry a shape and
a dtype and hold no memory — the port's ``ShapeDtypeStruct``, and what the
dry run (:mod:`repro_torch.launch.dryrun`) places and records against.
:func:`eval_shape` is ``jax.eval_shape``'s counterpart.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Union

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.frontends import audio_frame_specs
from repro_torch.models.transformer import DecoderLM
from repro_torch.tree import tree_map


def build_model(cfg: ModelConfig) -> Union[DecoderLM, EncDecLM]:
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    return DecoderLM(cfg)


def _meta(t):
    if not isinstance(t, torch.Tensor):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def eval_shape(fn: Callable[[], Any]) -> Any:
    """``fn()``'s output tree with every tensor a ``meta`` tensor of its
    shape and dtype.  ``fn`` runs under a ``FakeTensorMode``, so no
    arithmetic is done and no memory held: random draws on the CPU (an
    LM's ``init``) work at any size."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn()
    return tree_map(_meta, out)


def param_specs(model) -> Any:
    """The params tree of ``model.init`` as ``meta`` tensors."""
    return eval_shape(lambda: model.init(torch.Generator(), device="cpu"))


def _tokens(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _frames(cfg: ModelConfig, shape: InputShape) -> torch.Tensor:
    frame_shape, dtype = audio_frame_specs(cfg, shape)
    return torch.empty(frame_shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _tokens(b, s), "targets": _tokens(b, s)}
    if cfg.family == "encdec":
        specs["enc_inputs"] = _frames(cfg, shape)
    return specs


def decode_state_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Specs for (cache, token) of a one-token serve step with a seq_len
    cache (``init_cache`` on ``meta``: no memory at any length)."""
    model = build_model(cfg)
    b = shape.global_batch
    if cfg.family == "encdec":
        enc_len = max(1, shape.seq_len // cfg.encoder_frames_ratio)
        cache = model.init_cache(b, shape.seq_len, enc_len=enc_len,
                                 device="meta")
    else:
        cache = model.init_cache(b, shape.seq_len, device="meta")
    return {"cache": cache, "token": _tokens(b)}


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        specs = {"tokens": _tokens(shape.global_batch, shape.seq_len)}
        if cfg.family == "encdec":
            specs["enc_inputs"] = _frames(cfg, shape)
        return specs
    return decode_state_specs(cfg, shape)
