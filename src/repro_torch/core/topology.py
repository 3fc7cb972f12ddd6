"""The topology layer: WHICH workers average WHEN — as typed sync events
(PyTorch counterpart of ``repro.core.topology``).

A ``Topology`` answers:

* ``event_at(t)`` / ``schedule(T)`` — the typed ``SyncEvent`` (if any)
  fired after the local update of step ``t``;
* ``aggregate(tree, event, mask)`` — apply the event to a worker-stacked
  tree of tensors (leading axis n) through the installed ``Aggregator``;
* ``participants(event)`` — the workers whose state the event replaces
  (``participation()`` is its view on the Participation protocol);
* ``level_groupings()`` — the worker partition at every internal level
  (the runtime clock's barrier subtrees).

``UniformTopology`` (a ``HierarchySpec``; reshape-based means) and
``GroupedTopology`` (an explicit, possibly non-uniform ``Grouping`` with
per-group periods; (N, n) membership segment means) implement it.  For the
mesh executor, ``level_axes`` names the mesh axes whose group realizes an
event and ``shard_aggregate`` is the production lowering of an event for
one rank's row, as collectives over that group.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.aggregators import (Aggregator, AggregatorLike,
                                          axis_weighted_mean,
                                          denominator_floor, make_aggregator,
                                          segment_weighted_mean)
from repro_torch.core.grouping import Grouping, contiguous
from repro_torch.core.hierarchy import HierarchySpec, local_sgd, two_level
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class SyncEvent:
    """One aggregation event.

    level:  1 = global (paper level 1) ... M = innermost local sync.
    groups: per-group participation for a partial event (heterogeneous
            per-group periods I_i); None = every group at this level.
    weights: optional static per-worker weights for this event.
    """
    level: int
    groups: Optional[Tuple[bool, ...]] = None
    weights: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        assert self.level >= 1
        if self.groups is not None:
            assert any(self.groups), "an event with no syncing group"


def _tree_device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


class Topology(abc.ABC):
    """Contract for 'which workers average when, and how'.  Runtime
    participation masks enter as per-worker weights: a masked-out worker
    contributes nothing to any mean; whether it *receives* the result is
    the executor's contract, not the topology's."""

    n: int
    periods: Tuple[int, ...]
    aggregator: Aggregator

    @abc.abstractmethod
    def event_at(self, t: int) -> Optional[SyncEvent]:
        """The sync event fired after the update of step ``t`` (0-indexed)."""

    def schedule(self, T: int) -> Tuple[Optional[SyncEvent], ...]:
        return tuple(self.event_at(t) for t in range(T))

    @abc.abstractmethod
    def aggregate(self, tree, event: SyncEvent, mask=None):
        """Apply ``event`` to a worker-stacked tree (leading axis n).
        mask (n,) float/bool: runtime partial participation."""

    def participants(self, event: SyncEvent) -> Optional[np.ndarray]:
        """Static (n,) bool: the workers whose state ``event`` replaces, or
        None for all of them."""
        return None

    def participation(self):
        """This topology's static view of the Participation protocol
        (``event_mask == participants``; the dynamic scopes stay open)."""
        from repro_torch.population import StaticParticipation
        return StaticParticipation(self)

    def level_groupings(self) -> Dict[int, Grouping]:
        """Worker partition into the level-ℓ subtrees, for every internal
        level ℓ (the runtime clock builds its barrier subtrees from it).
        May be empty (single-level schedules have no internal grouping)."""
        return {}

    def level_axes(self, event: SyncEvent,
                   axis_names: Tuple[str, ...]) -> Tuple[str, ...]:
        """The mesh axes whose group realizes ``event``: for a uniform
        hierarchy (one axis per level, level 1 first) the axes of levels
        >= ``event.level``; a grouping with no uniform level structure
        lowers over all axes, the flat worker axis."""
        raise NotImplementedError(
            f"{type(self).__name__} does not map onto mesh axes; run it on "
            "the simulator (executor='sim')")

    def shard_aggregate(self, x, mesh, event: SyncEvent, *,
                        worker_index: int, weight=None):
        """Production mesh lowering of ``event`` for one rank's row: ``x``
        has a leading worker axis of 1, ``mesh`` is the
        :class:`~repro_torch.launch.mesh.HSGDMesh`, ``weight`` this rank's
        scalar weight (runtime mask times static weights; None = plain
        mean).  Agrees with :meth:`aggregate` to accumulation rounding (the
        collective sums in its own order); the bitwise path is the mesh
        executor's ``exact=True`` replay."""
        raise NotImplementedError(
            f"{type(self).__name__} has no mesh lowering; run it on the "
            "simulator (executor='sim')")

    def _event_weights(self, event: SyncEvent, mask,
                       device) -> Optional[torch.Tensor]:
        """Combine runtime mask, aggregator weights and event weights into
        one (n,) weight vector (None = plain mean)."""
        acc = self.aggregator.accum_dtype
        w = None
        for part in (mask, self.aggregator.worker_weights(self.n),
                     None if event.weights is None
                     else np.asarray(event.weights)):
            if part is None:
                continue
            p = torch.as_tensor(part, device=device).to(acc)
            w = p if w is None else w * p
        return w


class UniformTopology(Topology):
    """Uniform multi-level hierarchy (HierarchySpec); reshape-based means."""

    def __init__(self, spec: HierarchySpec, sync_dtype: Optional[str] = None,
                 aggregator: AggregatorLike = None):
        self.spec = spec
        self.n = spec.n_workers
        self.periods = spec.periods
        self.aggregator = make_aggregator(aggregator, sync_dtype=sync_dtype)

    def event_at(self, t: int) -> Optional[SyncEvent]:
        lvl = self.spec.sync_level(t)
        return None if lvl is None else SyncEvent(level=lvl)

    def level_groupings(self) -> Dict[int, Grouping]:
        return {l: contiguous(self.n, self.spec.n_at_level(l))
                for l in range(1, self.spec.num_levels)}

    def aggregate(self, tree, event: SyncEvent, mask=None):
        gs = tuple(self.spec.group_sizes)
        m = len(gs)
        assert 1 <= event.level <= m, (event, self.spec)
        assert event.groups is None, \
            "uniform hierarchies have no partial-group events; use " \
            "GroupedTopology or a runtime mask"
        axes = tuple(range(event.level - 1, m))
        agg = self.aggregator
        acc = agg.accum_dtype
        w = self._event_weights(event, mask, _tree_device(tree))

        def per_leaf(x):
            shaped = x.reshape(gs + tuple(x.shape[1:]))
            wr = None if w is None else \
                w.reshape(gs + (1,) * (shaped.ndim - m))
            payloads = agg.encode(shaped)
            means = {k: axis_weighted_mean(v, wr, axes, acc)
                     for k, v in payloads.items()}
            out = agg.decode(means, shaped)
            return out.expand(shaped.shape).reshape(x.shape)

        return tree_map(per_leaf, tree)

    def level_axes(self, event: SyncEvent,
                   axis_names: Tuple[str, ...]) -> Tuple[str, ...]:
        m = self.spec.num_levels
        assert len(axis_names) == m, \
            f"need one mesh axis per level, got {axis_names} for " \
            f"{m}-level {self.spec}"
        assert 1 <= event.level <= m, (event, self.spec)
        assert event.groups is None, \
            "uniform hierarchies never emit partial-group events"
        return tuple(axis_names[event.level - 1:])

    def shard_aggregate(self, x, mesh, event: SyncEvent, *,
                        worker_index: int, weight=None):
        axes = mesh.axes(self.level_axes(event, mesh.axis_names))
        return self.aggregator.axis_aggregate(x, axes, weight=weight)


class GroupedTopology(Topology):
    """Two-level H-SGD with an explicit (possibly non-uniform) Grouping and
    per-group local periods I_i.  Aggregation is an (N, n) membership
    segment mean; the global event is the unweighted mean of group means
    (paper A.1)."""

    def __init__(self, grouping: Grouping, G: int,
                 I: Union[int, Tuple[int, ...]],
                 sync_dtype: Optional[str] = None,
                 aggregator: AggregatorLike = None):
        self.grouping = grouping
        self.n = grouping.n
        self.G = G
        self.I = tuple([I] * grouping.N) if isinstance(I, int) else tuple(I)
        assert len(self.I) == grouping.N
        for Ii in self.I:
            assert G % Ii == 0, (G, Ii)
        self.periods = (G, min(self.I))
        self.aggregator = make_aggregator(aggregator, sync_dtype=sync_dtype)
        self._onehot = np.asarray(grouping.onehot())          # (N, n)
        self._assignment = np.asarray(grouping.assignment)    # (n,)

    def event_at(self, t: int) -> Optional[SyncEvent]:
        if (t + 1) % self.G == 0:
            return SyncEvent(level=1)
        groups = tuple(bool((t + 1) % Ii == 0) for Ii in self.I)
        if not any(groups):
            return None
        if all(groups):
            return SyncEvent(level=2)
        return SyncEvent(level=2, groups=groups)

    def level_groupings(self) -> Dict[int, Grouping]:
        return {1: self.grouping}

    def participants(self, event: SyncEvent) -> Optional[np.ndarray]:
        if event.level == 1 or event.groups is None:
            return None
        return np.asarray(event.groups)[self._assignment]

    def aggregate(self, tree, event: SyncEvent, mask=None):
        assert event.level in (1, 2), event
        agg = self.aggregator
        acc = agg.accum_dtype
        device = _tree_device(tree)
        oh = torch.as_tensor(self._onehot, device=device).to(acc)
        a = torch.as_tensor(self._assignment, device=device)
        if event.level == 1 or event.groups is None:
            syncing = np.ones(self.grouping.N, bool)
        else:
            syncing = np.asarray(event.groups)
        sync_workers = torch.as_tensor(syncing[self._assignment],
                                       device=device)           # (n,) bool
        w = self._event_weights(event, mask, device)
        w = torch.ones((self.n,), dtype=acc, device=device) if w is None \
            else w

        def per_leaf(x):
            flat = x.reshape(self.n, -1)
            payloads = agg.encode(flat)
            means = {}
            for k, v in payloads.items():
                gm = segment_weighted_mean(v, w, oh, acc)      # (N, dim)
                if event.level == 1:
                    # global = unweighted mean of group means (paper A.1)
                    gm = gm.mean(0, keepdim=True, dtype=acc).expand(
                        self.grouping.N, gm.shape[1])
                means[k] = gm[a]                               # (n, dim)
            out = agg.decode(means, flat)
            out = torch.where(sync_workers[:, None], out, flat)
            return out.to(x.dtype).reshape(x.shape)

        return tree_map(per_leaf, tree)

    def level_axes(self, event: SyncEvent,
                   axis_names: Tuple[str, ...]) -> Tuple[str, ...]:
        """Flat-worker-axis lowering: every event's collective runs over
        all axes; the membership lives in :meth:`shard_aggregate`'s one-hot
        weights."""
        assert event.level in (1, 2), event
        return tuple(axis_names)

    def shard_aggregate(self, x, mesh, event: SyncEvent, *,
                        worker_index: int, weight=None):
        """One sum over all ranks of (N, dim) membership-weighted
        numerators (this rank's one-hot column times its payload); each
        rank then keeps its own group's mean: the collective form of the
        (N, n) segment mean, N times a uniform level's payload."""
        assert event.level in (1, 2), event
        agg = self.aggregator
        acc = agg.accum_dtype
        N = self.grouping.N
        axes = mesh.axes(self.level_axes(event, mesh.axis_names))
        if event.level == 1 or event.groups is None:
            syncing = np.ones(N, bool)
        else:
            syncing = np.asarray(event.groups)
        gid = int(self._assignment[worker_index])
        col = torch.zeros((N,), dtype=acc, device=x.device)
        col[gid] = 1
        w = torch.ones((), dtype=acc, device=x.device) if weight is None \
            else weight.to(acc).reshape(())
        den = torch.maximum(axes.psum(col * w),
                            denominator_floor(acc, x.device))      # (N,)
        flat = x.reshape(x.shape[0], -1)                          # (1, dim)
        payloads = agg.encode(flat)
        means = {}
        for k, v in payloads.items():
            num = axes.psum(col[:, None] * (v.to(acc) * w))       # (N, dim)
            gm = num / den[:, None]
            if event.level == 1:
                # global = unweighted mean of group means (paper A.1)
                gm = gm.mean(0, keepdim=True, dtype=acc).expand(gm.shape)
            means[k] = gm[gid:gid + 1]
        out = agg.decode(means, flat)
        if not syncing[self._assignment[worker_index]]:
            out = flat
        return out.to(x.dtype).reshape(x.shape)


TOPOLOGIES = {}


def register_topology(name: str):
    def deco(builder):
        TOPOLOGIES[name.lower()] = builder
        return builder
    return deco


@register_topology("uniform")
def _build_uniform(*, spec: Optional[HierarchySpec] = None,
                   group_sizes=None, periods=None, **kw) -> UniformTopology:
    if spec is None:
        assert group_sizes is not None and periods is not None, \
            "uniform topology needs spec= or group_sizes=/periods="
        spec = HierarchySpec(tuple(group_sizes), tuple(periods))
    return UniformTopology(spec, **kw)


@register_topology("two_level")
def _build_two_level(*, n: int, N: int, G: int, I: int, **kw):
    return UniformTopology(two_level(n, N, G, I), **kw)


@register_topology("local_sgd")
def _build_local_sgd(*, n: int, P: int, **kw):
    return UniformTopology(local_sgd(n, P), **kw)


@register_topology("grouped")
def _build_grouped(*, grouping: Grouping, G: int, I, **kw):
    return GroupedTopology(grouping, G, I, **kw)


def make_topology(kind: Union[str, HierarchySpec, Grouping],
                  **kwargs) -> Topology:
    """Build a topology by registry name ("uniform" | "two_level" |
    "local_sgd" | "grouped"), or route a HierarchySpec / Grouping to the
    matching builder."""
    if isinstance(kind, HierarchySpec):
        return _build_uniform(spec=kind, **kwargs)
    if isinstance(kind, Grouping):
        return _build_grouped(grouping=kind, **kwargs)
    name = kind.lower()
    if name not in TOPOLOGIES:
        raise KeyError(f"unknown topology {kind!r}; "
                       f"known: {sorted(TOPOLOGIES)}")
    return TOPOLOGIES[name](**kwargs)
