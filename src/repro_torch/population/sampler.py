"""Population-scale virtual-client sampling (the PyTorch port's numpy copy
of ``repro.population.sampler``, code unchanged).

The engine's ``(n, ...)`` state materializes every worker, so n is bounded
by memory.  This module introduces the *population regime*: a declared
universe of ``prod(cells)`` virtual clients organized as a uniform tree that
mirrors the topology's hierarchy, from which each sampling round draws the
``k = topology.n`` active clients — **hierarchically** (sample cells at each
level, then clients per cell), so a two-level draw is "pick N_1 of C_1
cells, then N_2 of C_2 clients inside each picked cell".

Purity contract (same as :mod:`repro_torch.runtime.stragglers`): every draw is a
counter-based function of ``(seed, round, level, cell-path)`` — calling
:meth:`HierarchicalSampler.draw` twice for the same round returns identical
draws, two populations with different seeds are independent, and NOTHING of
size O(population) is ever materialized (draws are rejection-sampled, so
cost and memory scale with k, not with ``prod(cells)``).

Because cell picks are sorted, the slot layout is cell-major and static: the
j-th engine slot always belongs to the j-th drawn cell of its level, so the
*topology over slots* never changes (one jit cache for every round) while
the *clients behind the slots* are redrawn every round — exactly the
paper's Theorem-2 random regrouping, now drawn from a population instead of
permuting a materialized n (see :meth:`Draw.grouping`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.core.grouping import Grouping

_SALT = 0x90BC11  # population-layer namespace (stragglers use 0x5712A6)


def _rng(seed: int, *ctx: int) -> np.random.Generator:
    """Counter-based generator: pure in (seed, *ctx), independent across
    distinct contexts."""
    return np.random.default_rng([_SALT, int(seed)] + [int(c) for c in ctx])


def _draw_without_replacement(rng: np.random.Generator, n: int,
                              k: int) -> np.ndarray:
    """k distinct ints from range(n), sorted.  O(k) memory: the population
    regime has n up to 10^6+ per level and k tiny, where materializing
    ``rng.choice(n, ..., replace=False)``'s internal permutation would cost
    O(n); rejection sampling keeps the draw bounded by the slot count."""
    assert 0 <= k <= n, (k, n)
    if k == n:
        return np.arange(n, dtype=np.int64)
    if 4 * k >= n:  # dense draw: the permutation is the cheap path
        return np.sort(rng.choice(n, size=k, replace=False).astype(np.int64))
    picked: set = set()
    while len(picked) < k:
        for c in rng.integers(0, n, size=k - len(picked)):
            picked.add(int(c))
    return np.sort(np.fromiter(picked, np.int64, len(picked)))


@dataclasses.dataclass(frozen=True)
class Draw:
    """One round's resolved participation: which virtual clients occupy the
    k engine slots.  ``client_ids[j] == -1`` marks an *empty slot* — the
    sampled client never responded (availability) — which the engine masks
    out of every sync and weighs 0 at fold-back."""
    round_index: int
    client_ids: np.ndarray   # (k,) int64 leaf ids into the population; -1 empty
    paths: np.ndarray        # (k, M) per-level cell indices of each slot

    @property
    def k(self) -> int:
        return len(self.client_ids)

    @property
    def active(self) -> np.ndarray:
        """(k,) bool — slots whose client responded."""
        return self.client_ids >= 0

    def grouping(self) -> Grouping:
        """The round's Theorem-2 regrouping of slots by drawn top-level cell
        (slot-side it is always the same contiguous grouping — the
        *membership* behind it is what the draw randomizes)."""
        return Grouping.from_labels(self.paths[:, 0])

    def num_cells(self) -> int:
        return len(np.unique(self.paths[:, 0]))


@dataclasses.dataclass(frozen=True)
class Population:
    """Declarative population spec (resolves via :func:`make_population`;
    binds to an engine through ``EngineConfig(population=...)``).

    cells: per-level fanout ``(C_1, ..., C_M)`` mirroring the topology's
        ``group_sizes (N_1, ..., N_M)``; the population is the
        ``prod(cells)`` leaves of the uniform tree and a round draws N_l of
        C_l branches at each level (so ``C_l >= N_l`` is required).
    seed: sampler namespace — draws are pure in ``(seed, round)``.
    weighting: fold-back client weights — ``"uniform"`` or ``"size"``
        (dataset-size proportional; sizes come from the data layer, e.g.
        :meth:`repro_torch.data.federated.PopulationShards.client_size`).
    p_available: probability a *drawn* client responds (pure per
        ``(seed, round, client)``); non-respondents become empty slots.
    staleness_decay: per-missed-barrier fold-back discount for slots the
        elastic runtime dropped from the round's last admitted sync
        (``SimClock.last_admitted``); 1.0 disables.
    fold: ``"dense"`` (weighted mean over slots), ``"nonzero"`` (per-entry
        nonzero-mask weighted mean — the fed-dropout idiom for sparse/topk
        payloads, zero-denominator entries keep the server value), or
        ``"auto"`` (nonzero iff the engine's wire codec is sparse).
    """
    cells: Tuple[int, ...]
    seed: int = 0
    weighting: str = "uniform"
    p_available: float = 1.0
    staleness_decay: float = 1.0
    fold: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "cells", tuple(int(c) for c in self.cells))
        assert all(c >= 1 for c in self.cells), self.cells
        assert self.weighting in ("uniform", "size"), self.weighting
        assert 0.0 <= self.p_available <= 1.0, self.p_available
        assert 0.0 <= self.staleness_decay <= 1.0, self.staleness_decay
        assert self.fold in ("auto", "dense", "nonzero"), self.fold

    @property
    def size(self) -> int:
        return math.prod(self.cells)

    def describe(self) -> dict:
        return {"population": self.size, "cells": list(self.cells),
                "seed": self.seed, "weighting": self.weighting,
                "p_available": self.p_available,
                "staleness_decay": self.staleness_decay, "fold": self.fold}


PopulationLike = Optional[object]  # None | Population | (C_1, ..., C_M)


def make_population(spec: PopulationLike = None) -> Optional[Population]:
    """None → None; a Population passes through; a tuple/list of per-level
    fanouts (or a bare int for single-level) builds a default Population."""
    if spec is None or isinstance(spec, Population):
        return spec
    if isinstance(spec, int):
        return Population(cells=(spec,))
    if isinstance(spec, (tuple, list)):
        return Population(cells=tuple(spec))
    raise TypeError(f"population spec must be None, a Population, an int or "
                    f"a per-level fanout tuple; got {spec!r}")


class HierarchicalSampler:
    """Draws ``k = prod(group_sizes)`` clients per round from a
    :class:`Population` whose tree mirrors ``group_sizes`` level for level."""

    def __init__(self, population: Population,
                 group_sizes: Tuple[int, ...]):
        cells, gs = population.cells, tuple(int(g) for g in group_sizes)
        if len(cells) != len(gs):
            raise ValueError(
                f"population cells {cells} must declare one fanout per "
                f"hierarchy level (topology has {len(gs)} levels "
                f"{gs}); e.g. a two-level (N, K) topology over a "
                f"1000x1000-client population is cells=(1000, 1000)")
        for l, (c, g) in enumerate(zip(cells, gs), start=1):
            if c < g:
                raise ValueError(
                    f"level-{l} draw needs {g} of {c} population cells — "
                    f"cells[{l - 1}] must be >= group_sizes[{l - 1}]")
        self.population = population
        self.group_sizes = gs
        self.k = math.prod(gs)
        # leaf id = mixed-radix path over the population fanouts
        self._radix = np.array(
            [math.prod(cells[l + 1:]) for l in range(len(cells))], np.int64)

    def draw(self, round_index: int) -> Draw:
        """Pure in ``(population.seed, round_index)``."""
        pop, r = self.population, int(round_index)
        prefixes: list = [()]
        for l, (c, g) in enumerate(zip(pop.cells, self.group_sizes)):
            nxt = []
            for p in prefixes:
                picks = _draw_without_replacement(
                    _rng(pop.seed, 1, r, l, *p), c, g)
                nxt += [p + (int(i),) for i in picks]
            prefixes = nxt
        paths = np.asarray(prefixes, np.int64).reshape(self.k, -1)
        ids = paths @ self._radix
        if pop.p_available < 1.0:
            # availability is applied post-draw (the sampled device never
            # responded), so the draw itself stays O(k)
            u = np.array([_rng(pop.seed, 2, r, int(c) + 1).random()
                          for c in ids])
            ids = np.where(u < pop.p_available, ids, np.int64(-1))
        return Draw(round_index=r, client_ids=ids, paths=paths)


def default_client_sizes(seed: int = 0, log_mean: float = 5.0,
                         log_sigma: float = 1.0) -> Callable[[int], float]:
    """Default dataset-size law for ``weighting="size"`` when no data layer
    provides one: heavy-tailed lognormal per-client example counts, pure in
    ``(seed, client_id)`` (``PopulationShards.client_size`` uses the same
    law so weights and data agree)."""
    def size(client_id: int) -> float:
        if client_id < 0:
            return 0.0
        return float(1 + int(_rng(seed, 3, int(client_id) + 1)
                             .lognormal(log_mean, log_sigma)))
    return size
