"""Aggregation rules for H-SGD sync events (PyTorch counterpart of
``repro.core.aggregators``).

An ``Aggregator`` factors a rule into two leaf-level hooks around the one
collective a topology knows how to do — a weighted mean:

    payloads = agg.encode(x)          # dict of tensors shaped like x
    means    = {k: weighted_mean(v) for k, v in payloads.items()}
    new_x    = agg.decode(means, x)   # back to x.dtype

Two forms of the mean: the segment form (in-array means over the worker
axis, what the sim executor runs) and the axis-collective form
(:meth:`Aggregator.axis_aggregate`: a sum over a mesh group of processes,
what the mesh executor's production lowering runs; the group is a
:class:`~repro_torch.launch.mesh.MeshAxes`).  Every rule of the reference is
here: the plain mean, the compressed (bf16) mean, the fixed-weight mean and
the SignSGD vote.
"""
from __future__ import annotations

import abc
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch import marks
from repro_torch.device import recip_f32


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

    def axis_aggregate(self, x: torch.Tensor, axes,
                       weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Axis-collective form: the same encode/mean/decode, the mean a
        sum over the processes of ``axes`` (the syncing levels' group).
        ``weight`` is this rank's scalar worker weight, or None."""
        payloads = self.encode(x)
        means = {k: named_axis_weighted_mean(v, weight, axes,
                                             self.accum_dtype)
                 for k, v in payloads.items()}
        return self.decode(means, x)


class MeanAggregator(Aggregator):
    """Exact paper semantics: mean of the participating workers."""

    def __init__(self, dtype: str = "float32"):
        self.accum_dtype = _torch_dtype(dtype)

    def __repr__(self):
        return f"MeanAggregator({str(self.accum_dtype).replace('torch.', '')})"


class CompressedAggregator(MeanAggregator):
    """Mean with a compressed payload (default bf16): the payload and the
    accumulation of the mean are in ``dtype``."""

    def __init__(self, dtype: str = "bfloat16"):
        super().__init__(dtype)

    def __repr__(self):
        return ("CompressedAggregator("
                f"{str(self.accum_dtype).replace('torch.', '')})")


class WeightedAggregator(Aggregator):
    """Weighted mean with fixed per-worker weights (e.g. dataset-size
    proportional FedAvg weights).  Weights multiply the participation
    mask, so a masked sync means over ``mask * weights``."""

    def __init__(self, weights, dtype: str = "float32"):
        self.weights = np.asarray(weights, np.float64)
        if self.weights.ndim != 1 or (self.weights < 0).any() or \
                self.weights.sum() <= 0:
            raise ValueError("WeightedAggregator: weights must be a 1-D "
                             "non-negative vector with a positive sum")
        self.accum_dtype = _torch_dtype(dtype)

    def worker_weights(self, n: int) -> np.ndarray:
        if len(self.weights) != n:
            raise ValueError(f"WeightedAggregator has {len(self.weights)} "
                             f"weights for {n} workers")
        return self.weights

    def __repr__(self):
        return f"WeightedAggregator(n={len(self.weights)})"


class SignSGDAggregator(Aggregator):
    """Majority-vote 1-bit rule (Bernstein et al.) on the sync payload:
    each participant sends sign(x) and |x|; the aggregate is
    mean|x| * sign(mean sign), exact ties giving 0.  Lossy by design."""

    def __init__(self, dtype: str = "float32"):
        self.accum_dtype = _torch_dtype(dtype)

    def encode(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        xf = x.to(self.accum_dtype)
        return {"sign": torch.sign(xf), "magnitude": xf.abs()}

    def decode(self, means: Dict[str, torch.Tensor],
               like: torch.Tensor) -> torch.Tensor:
        return (means["magnitude"] * torch.sign(means["sign"])).to(
            like.dtype)

    def __repr__(self):
        return "SignSGDAggregator()"


AGGREGATORS = {
    "mean": MeanAggregator,
    "compressed": CompressedAggregator,
    "bf16": CompressedAggregator,
    "weighted": WeightedAggregator,
    "sign": SignSGDAggregator,
    "signsgd": SignSGDAggregator,
}

AggregatorLike = Union[str, Aggregator, None]


def make_aggregator(spec: AggregatorLike = None, *,
                    sync_dtype: Optional[str] = None, **kwargs) -> Aggregator:
    """Resolve an aggregator from an instance, a registry name, or the
    ``sync_dtype`` flag (``'bfloat16'`` -> CompressedAggregator)."""
    if isinstance(spec, Aggregator):
        if sync_dtype is not None:
            raise ValueError(
                f"sync_dtype={sync_dtype!r} only applies when constructing "
                f"by name; got the instance {spec!r}")
        if kwargs:
            raise ValueError("kwargs only apply when constructing by name")
        return spec
    if spec is None:
        if sync_dtype is not None and \
                _torch_dtype(sync_dtype) != torch.float32:
            return CompressedAggregator(sync_dtype)
        return MeanAggregator()
    name = spec.lower()
    if name not in AGGREGATORS:
        raise KeyError(f"unknown aggregator {spec!r}; "
                       f"known: {sorted(AGGREGATORS)}")
    if sync_dtype is not None:
        kwargs.setdefault("dtype", sync_dtype)
    return AGGREGATORS[name](**kwargs)


def register_aggregator(name: str, cls) -> None:
    AGGREGATORS[name.lower()] = cls


def denominator_floor(acc: torch.dtype, device=None) -> torch.Tensor:
    """Positive floor for weighted-mean denominators: the accumulation
    dtype's smallest positive normal, so an all-masked group divides to an
    exact 0 instead of 0/0 = NaN."""
    return torch.tensor(torch.finfo(acc).tiny, dtype=acc, device=device)


def _sum_in(v: torch.Tensor, axes, acc: torch.dtype) -> torch.Tensor:
    """Sum of ``v`` over ``axes`` (keepdim) accumulated in ``acc``.

    A float32 sum is ``torch.sum``.  A narrower ``acc`` (bf16, f16) is
    rounded to ``acc`` after every add, one slice after the other in the
    row-major order of ``axes``: that is how XLA reduces in such a type,
    while ``torch.sum`` would accumulate in float32 and round once.  Either
    way one reduce for the analysis layer (:func:`repro_torch.marks.
    reduce`)."""
    if acc == torch.float32:
        return v.sum(dim=axes, keepdim=True, dtype=acc)
    keep = [d for d in range(v.ndim) if d not in axes]
    with marks.reduce("sum_in", v, dtype=acc):
        slices = v.to(acc).permute(list(axes) + keep).reshape(
            (-1,) + tuple(v.shape[d] for d in keep))
        out = torch.zeros(slices.shape[1:], dtype=acc, device=v.device)
        for piece in slices:
            out = out + piece
    return out.reshape([1 if d in axes else v.shape[d]
                        for d in range(v.ndim)])


def axis_weighted_mean(v: torch.Tensor, w: Optional[torch.Tensor], axes,
                       acc: torch.dtype) -> torch.Tensor:
    """Mean of ``v`` over ``axes`` (keepdim), optionally weighted by ``w``
    (broadcastable), accumulated in ``acc`` (see :func:`_sum_in`)."""
    axes = tuple(axes)
    if w is None:
        if acc == torch.float32:
            return v.to(acc).mean(dim=axes, keepdim=True, dtype=acc)
        count = 1
        for d in axes:
            count *= v.shape[d]
        # division rule: XLA multiplies by the f32 reciprocal of the count
        return _sum_in(v, axes, acc) * recip_f32(count)
    num = _sum_in(v.to(acc) * w, axes, acc)
    den = torch.maximum(_sum_in(w, axes, acc),
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


def flat_worker_index(mesh) -> int:
    """This rank's flat worker index: row-major over the mesh's replica
    axes (outermost first), the order of the worker axis."""
    idx = 0
    for c, size in zip(mesh.coords, mesh.group_sizes):
        idx = idx * size + c
    return idx


def named_axis_weighted_mean(v: torch.Tensor, w: Optional[torch.Tensor],
                             axes, acc: torch.dtype) -> torch.Tensor:
    """Process-group counterpart of :func:`axis_weighted_mean`: the
    level-ℓ mean is a sum over the group of the axes of levels >= ℓ.
    ``w`` is this rank's scalar worker weight (or None)."""
    if not axes.names:
        return v.to(acc)
    if w is None:
        # the reference's pmean: psum, then the constant 1/size folded
        return axes.psum(v.to(acc)) * recip_f32(axes.size)
    w = w.to(acc).reshape(())
    num = axes.psum(v.to(acc) * w)
    den = torch.maximum(axes.psum(w), denominator_floor(acc, v.device))
    return num / den


def named_axis_sum(v: torch.Tensor, axes,
                   w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Wire-dtype sum over the group: the operand's own dtype rides the
    collective (int32 sums as int32).  ``w`` is this rank's 0/1
    participation weight, so a masked rank contributes exact zeros."""
    if not axes.names:
        return v
    if w is not None:
        v = v * w.to(v.dtype)
    return axes.psum(v)


def named_axis_max(v: torch.Tensor, axes,
                   w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max over the group of NON-NEGATIVE statistics (block amax): a masked
    rank's row is zeroed, never pulling a real max below zero."""
    if not axes.names:
        return v
    if w is not None:
        v = v * w.to(v.dtype)
    return axes.pmax(v)
