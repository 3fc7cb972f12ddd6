"""Synthetic LM token pipeline (PyTorch counterpart of
``repro.data.synthetic``).

Deterministic, seekable stream: batch t of worker w is a pure function of
``(seed, t, w)``, so restarts resume exactly from the step counter.  The
reference draws its uniform tokens and its keep mask from JAX's PRNG,
which the port does not re-implement: here they come from
``numpy.random.default_rng((seed, step, worker))`` on the host, so the
card and the CPU see the same tokens.  The Markov structure on top of
the draw, :func:`markov_fold`, is the reference's ``lax.scan`` bit for
bit on the same ``rand`` and ``keep``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

KEEP_P = 0.75   # the share of transitions that follow the Markov rule


def markov_fold(rand: torch.Tensor, keep: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """rand (B, S+1) int, keep (B, S) bool -> tokens (B, S+1): token 0 is
    ``rand[:, 0]``, then token_{i+1} = (7 * token_i + 1) mod vocab where
    ``keep[:, i]``, else ``rand[:, i+1]``."""
    rand = torch.as_tensor(rand)
    keep = torch.as_tensor(keep)
    toks = [rand[:, 0]]
    for i in range(keep.shape[1]):
        toks.append(torch.where(keep[:, i], (toks[-1] * 7 + 1) % vocab,
                                rand[:, i + 1]))
    return torch.stack(toks, dim=1)


def _draw(seed: int, step: int, worker: int, batch: int, seq_len: int,
          vocab: int):
    rng = np.random.default_rng((seed, step, worker))
    rand = rng.integers(0, vocab, (batch, seq_len + 1), dtype=np.int32)
    keep = rng.random((batch, seq_len)) < KEEP_P
    return torch.from_numpy(rand), torch.from_numpy(keep)


def synth_lm_batch(seed: int, step: int, batch: int, seq_len: int,
                   vocab: int, worker: int = 0) -> Dict[str, torch.Tensor]:
    """Markov-ish synthetic tokens (int32, on the host): learnable
    structure (the next token depends on the current one), so CE falls
    during training."""
    toks = markov_fold(*_draw(seed, step, worker, batch, seq_len, vocab),
                       vocab)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclasses.dataclass
class TokenStream:
    seed: int
    batch: int
    seq_len: int
    vocab: int
    n_workers: int = 1
    device: DeviceLike = "cpu"

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        """Batch with a leading worker axis (H-SGD layout), moved to
        ``device`` as one tensor.  Each worker's draw is its own; the
        fold runs once over all workers' rows."""
        rand, keep = zip(*(_draw(self.seed, step, w, self.batch,
                                 self.seq_len, self.vocab)
                           for w in range(self.n_workers)))
        toks = markov_fold(torch.cat(rand), torch.cat(keep), self.vocab)
        toks = toks.reshape(self.n_workers, self.batch, self.seq_len + 1)
        toks = toks.to(resolve_device(self.device))
        return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}
