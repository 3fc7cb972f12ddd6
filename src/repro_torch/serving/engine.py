"""Batched serving engine: prefill once, decode step-by-step (PyTorch
counterpart of ``repro.serving.engine``).

Caches come from the model (full KV and sliding-window ring, see
:func:`repro_torch.models.transformer.block_cache_init`; an
encoder-decoder's also hold each layer's cross-attention k/v, from the
``enc_inputs`` given to ``generate`` and ``score_continuation``).  All
requests in a batch decode in lockstep.  Tokens and log-probabilities
stay on the model's device until the end of a call, so a step does not
wait for the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, gen_len)
    logprobs: np.ndarray        # (B, gen_len)
    steps: int


class DecodeEngine:
    """Serves ``model`` with ``params`` on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``); the params must already live there."""

    def __init__(self, model, params, *, temperature: float = 0.0,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        where = params["embed"].device
        if where.type != self.device.type or (
                self.device.index is not None
                and where.index != self.device.index):
            raise ValueError(f"DecodeEngine: params are on {where}, the "
                             f"engine on {self.device}")
        self.model = model
        self.params = params
        self.temperature = temperature

    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        return tokens.to(self.params["embed"].device, torch.long)

    def _prefill(self, prompt: torch.Tensor, max_len: int, enc_inputs):
        """The model's prefill, with the encoder's frames where given (an
        encoder-decoder's; on the model's device, in whatever dtype)."""
        kw = {}
        if enc_inputs is not None:
            if not isinstance(enc_inputs, torch.Tensor):
                enc_inputs = torch.from_numpy(np.asarray(enc_inputs))
            kw["enc_inputs"] = enc_inputs.to(prompt.device)
        return self.model.prefill(self.params, prompt, max_len=max_len, **kw)

    def _sample(self, gen: torch.Generator, logits: torch.Tensor):
        """Greedy ``argmax``, or a draw from softmax(logits / temperature)
        by the Gumbel-max rule with uniforms from ``gen``."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=gen, device=gen.device)
        gumbel = -torch.log(-torch.log(u.to(logits.device)))
        return torch.argmax(logits.to(torch.float32) / self.temperature
                            + gumbel, dim=-1)

    @staticmethod
    def _logp_of(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        return logp.gather(-1, tok[:, None])[:, 0]

    def generate(self, prompt, gen_len: int, *,
                 generator: Optional[torch.Generator] = None,
                 enc_inputs=None) -> GenerationResult:
        """prompt: (B, S) token ids. Greedy (or temperature) continuation;
        ``generator`` (default: seed 0 on the model's device) drives the
        sampling when the temperature is above 0; ``enc_inputs`` (B, F, D)
        are an encoder-decoder's frames."""
        prompt = self._tokens(prompt)
        if generator is None:
            generator = torch.Generator(
                device=prompt.device).manual_seed(0)
        b, s = prompt.shape
        logits, cache = self._prefill(prompt, s + gen_len, enc_inputs)
        toks, lps = [], []
        tok = self._sample(generator, logits)
        for t in range(gen_len):
            lps.append(self._logp_of(logits, tok))
            toks.append(tok)
            if t + 1 < gen_len:
                logits, cache = self.model.decode_step(self.params, cache, tok)
                tok = self._sample(generator, logits)
        return GenerationResult(torch.stack(toks, 1).cpu().numpy(),
                                torch.stack(lps, 1).cpu().numpy(), gen_len)

    def score_continuation(self, prompt, continuation,
                           enc_inputs=None) -> np.ndarray:
        """Sum logprob of a given continuation (evaluation utility)."""
        prompt = self._tokens(prompt)
        continuation = self._tokens(continuation)
        b, s = prompt.shape
        g = continuation.shape[1]
        logits, cache = self._prefill(prompt, s + g, enc_inputs)
        lps = []
        for t in range(g):
            tok = continuation[:, t]
            lps.append(self._logp_of(logits, tok))
            if t + 1 < g:
                logits, cache = self.model.decode_step(self.params, cache, tok)
        return torch.stack(lps, 1).cpu().numpy().astype(np.float64).sum(1)
