"""Hierarchy specification for multi-level H-SGD (paper Algorithm 1 / D.1).

Numpy-only: a copy of ``repro.core.hierarchy``, held equal to it by the
tests.

Levels are 1-indexed as in the paper: level 1 is the *global* aggregation
(period ``P_1 = G``), level M the innermost local aggregation
(period ``P_M``, the two-level ``I``).  A level-ℓ aggregation averages worker
models over index positions ℓ..M of the worker path (k_1, ..., k_M) — i.e.
within each level-(ℓ-1) server's subtree — and the *highest* matching level
wins at any step (the ``break`` in Algorithm D.1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """Uniform multi-level hierarchy: server at level ℓ-1 has N_ℓ children.

    group_sizes: (N_1, ..., N_M)  — n = prod(group_sizes) workers.
    periods:     (P_1, ..., P_M)  — P_1 > P_2 > ... > P_M >= 1,
                                    P_{ℓ+1} divides P_ℓ.
    Two-level H-SGD(G, I, N groups of K): group_sizes=(N, K), periods=(G, I).
    Local SGD with period P: group_sizes=(n,), periods=(P,).
    """
    group_sizes: Tuple[int, ...]
    periods: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.group_sizes) == len(self.periods) >= 1
        for a, b in zip(self.periods, self.periods[1:]):
            assert a >= b and a % b == 0, \
                f"periods must be nested multiples, got {self.periods}"
        assert all(s >= 1 for s in self.group_sizes)
        assert all(p >= 1 for p in self.periods)

    # -- structure ----------------------------------------------------------
    @property
    def num_levels(self) -> int:
        return len(self.group_sizes)

    @property
    def n_workers(self) -> int:
        return int(np.prod(self.group_sizes))

    @property
    def G(self) -> int:
        return self.periods[0]

    @property
    def I(self) -> int:
        return self.periods[-1]

    def n_at_level(self, level: int) -> int:
        """n_ℓ = prod_{j<=ℓ} N_j — number of level-ℓ subtrees (paper's n_ℓ)."""
        return int(np.prod(self.group_sizes[:level]))

    # -- schedule -------------------------------------------------------------
    def sync_level(self, t: int) -> Optional[int]:
        """Aggregation level after the update of step ``t`` (0-indexed):
        the smallest ℓ (highest level) with P_ℓ | t+1, else None."""
        for lvl, p in enumerate(self.periods, start=1):
            if (t + 1) % p == 0:
                return lvl
        return None

    def schedule(self, T: int) -> Tuple[Optional[int], ...]:
        return tuple(self.sync_level(t) for t in range(T))

    def sync_counts(self, T: int) -> Tuple[int, ...]:
        """Number of level-ℓ events in T steps, ℓ = 1..M (the break
        semantics make these disjoint: a level-1 step is NOT also counted
        at level 2) — the input to communication-cost models."""
        counts = [0] * self.num_levels
        for t in range(T):
            lvl = self.sync_level(t)
            if lvl is not None:
                counts[lvl - 1] += 1
        return tuple(counts)


def two_level(n: int, N: int, G: int, I: int) -> HierarchySpec:
    assert n % N == 0, (n, N)
    return HierarchySpec(group_sizes=(N, n // N), periods=(G, I))


def local_sgd(n: int, P: int) -> HierarchySpec:
    return HierarchySpec(group_sizes=(n,), periods=(P,))
