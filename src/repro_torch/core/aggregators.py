"""Aggregation rules for H-SGD sync events (PyTorch counterpart of
``repro.core.aggregators``).

An ``Aggregator`` factors a rule into two leaf-level hooks around the one
collective a topology knows how to do — a weighted mean:

    payloads = agg.encode(x)          # dict of tensors shaped like x
    means    = {k: weighted_mean(v) for k, v in payloads.items()}
    new_x    = agg.decode(means, x)   # back to x.dtype

This slice ports the segment form (in-array means over the worker axis,
what the sim executor runs) and the plain mean rule.  The compressed,
weighted and sign rules come with ROADMAP item A2's remainder; the
named-axis forms come with the mesh executor (ROADMAP A8).
"""
from __future__ import annotations

import abc
from typing import Dict, Optional, Union

import numpy as np
import torch


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


class Aggregator(abc.ABC):
    """A sync rule: encode worker payloads, mean them, decode the result.
    ``accum_dtype`` is both the payload dtype and the accumulation dtype of
    the mean."""

    accum_dtype = torch.float32

    def encode(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"value": x.to(self.accum_dtype)}

    def decode(self, means: Dict[str, torch.Tensor],
               like: torch.Tensor) -> torch.Tensor:
        return means["value"].to(like.dtype)

    def worker_weights(self, n: int) -> Optional[np.ndarray]:
        """Optional static per-worker weights, multiplied into the
        participation mask by the topology."""
        return None


class MeanAggregator(Aggregator):
    """Exact paper semantics: mean of the participating workers."""

    def __init__(self, dtype: str = "float32"):
        self.accum_dtype = _torch_dtype(dtype)

    def __repr__(self):
        return f"MeanAggregator({str(self.accum_dtype).replace('torch.', '')})"


AGGREGATORS = {"mean": MeanAggregator}
# registered in the JAX package, not ported yet
_NOT_PORTED = ("compressed", "bf16", "weighted", "sign", "signsgd")

AggregatorLike = Union[str, Aggregator, None]


def make_aggregator(spec: AggregatorLike = None, *,
                    sync_dtype: Optional[str] = None, **kwargs) -> Aggregator:
    """Resolve an aggregator from an instance, a registry name, or None."""
    if isinstance(spec, Aggregator):
        if sync_dtype is not None:
            raise ValueError(
                f"sync_dtype={sync_dtype!r} only applies when constructing "
                f"by name; got the instance {spec!r}")
        assert not kwargs, "kwargs only apply when constructing by name"
        return spec
    if spec is None:
        if sync_dtype is not None and \
                _torch_dtype(sync_dtype) != torch.float32:
            raise NotImplementedError(
                f"sync_dtype={sync_dtype!r} selects the compressed "
                "aggregator, which is not ported yet (ROADMAP A2)")
        return MeanAggregator()
    name = spec.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"aggregator {spec!r} is not ported yet (ROADMAP A2); the port "
            f"has {sorted(AGGREGATORS)}")
    if name not in AGGREGATORS:
        raise KeyError(f"unknown aggregator {spec!r}; "
                       f"known: {sorted(AGGREGATORS)}")
    if sync_dtype is not None:
        kwargs.setdefault("dtype", sync_dtype)
    return AGGREGATORS[name](**kwargs)


def denominator_floor(acc: torch.dtype, device=None) -> torch.Tensor:
    """Positive floor for weighted-mean denominators: the accumulation
    dtype's smallest positive normal, so an all-masked group divides to an
    exact 0 instead of 0/0 = NaN."""
    return torch.tensor(torch.finfo(acc).tiny, dtype=acc, device=device)


def axis_weighted_mean(v: torch.Tensor, w: Optional[torch.Tensor], axes,
                       acc: torch.dtype) -> torch.Tensor:
    """Mean of ``v`` over ``axes`` (keepdim), optionally weighted by ``w``
    (broadcastable), accumulated in ``acc``."""
    axes = tuple(axes)
    if w is None:
        return v.to(acc).mean(dim=axes, keepdim=True, dtype=acc)
    num = (v.to(acc) * w).sum(dim=axes, keepdim=True, dtype=acc)
    den = torch.maximum(w.sum(dim=axes, keepdim=True, dtype=acc),
                        denominator_floor(acc, v.device))
    return num / den


def segment_weighted_mean(v: torch.Tensor, w: torch.Tensor,
                          membership: torch.Tensor,
                          acc: torch.dtype) -> torch.Tensor:
    """Per-group weighted mean of flat worker values.

    v: (n, dim) payload; w: (n,) weights; membership: (N, n) one-hot.
    Returns (N, dim) group means."""
    num = membership @ (w[:, None] * v.to(acc))
    den = torch.maximum(membership @ w,
                        denominator_floor(acc, v.device))[:, None]
    return num / den
