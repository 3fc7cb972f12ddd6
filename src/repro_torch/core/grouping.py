"""Two-level worker groupings (paper §3, §4.3).

Numpy-only: the part of ``repro.core.grouping`` the H-SGD experiments
need (``Grouping`` with its mixing matrices, ``contiguous``,
``random_grouping`` and the Fig. 3c and Appendix E constructions
``group_iid``, ``group_noniid``, ``diversity_grouping``,
``sample_participation``), copied and held equal to it by the tests.  A
``Grouping`` is an explicit assignment of n workers to N groups (possibly
non-uniform, as Theorem 1 allows).  The paper's aggregation semantics
(Algorithm 1) as mixing matrices:
  local  A_loc[j, j'] = 1/n_i   if j, j' in the same group V_i
  global A_glob[j, j'] = (1/N) * 1/n_{i(j')}   (unweighted mean of group means)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grouping:
    assignment: tuple  # length n, group ids 0..N-1

    def __post_init__(self):
        a = np.asarray(self.assignment)
        assert a.ndim == 1 and a.min() >= 0
        ids = np.unique(a)
        assert (ids == np.arange(len(ids))).all(), "group ids must be dense"

    @classmethod
    def from_labels(cls, labels) -> "Grouping":
        """Grouping from arbitrary per-worker labels (dense-relabelled in
        order of first appearance)."""
        labels = np.asarray(labels)
        assert labels.ndim == 1 and len(labels) > 0, labels.shape
        _, ids = np.unique(labels, return_inverse=True)
        first = {}
        dense = np.empty(len(labels), np.int64)
        for j, g in enumerate(ids):
            dense[j] = first.setdefault(int(g), len(first))
        return cls(tuple(dense))

    @property
    def n(self) -> int:
        return len(self.assignment)

    @property
    def N(self) -> int:
        return int(max(self.assignment)) + 1

    @property
    def sizes(self) -> np.ndarray:
        return np.bincount(np.asarray(self.assignment), minlength=self.N)

    def members(self, i: int) -> np.ndarray:
        return np.nonzero(np.asarray(self.assignment) == i)[0]

    # -- mixing matrices (paper Appendix A.1) --------------------------------
    def local_matrix(self) -> np.ndarray:
        a = np.asarray(self.assignment)
        same = a[:, None] == a[None, :]
        return same / self.sizes[a][None, :].T  # row j: 1/n_{i(j)} over V_{i(j)}

    def global_matrix(self) -> np.ndarray:
        a = np.asarray(self.assignment)
        w = 1.0 / (self.N * self.sizes[a])     # each worker j' weighted 1/(N n_i(j'))
        return np.tile(w[None, :], (self.n, 1))

    def onehot(self) -> np.ndarray:
        """(N, n) membership indicator."""
        a = np.asarray(self.assignment)
        return (np.arange(self.N)[:, None] == a[None, :]).astype(np.float64)

    def size_weights(self) -> np.ndarray:
        """(n,) weights proportional to each worker's group size inverse, so a
        weighted GLOBAL mean over workers equals the unweighted mean of group
        means (pairs with ``WeightedAggregator`` for FedAvg-style runs)."""
        return 1.0 / (self.N * self.sizes[np.asarray(self.assignment)])


def contiguous(n: int, N: int) -> Grouping:
    assert n % N == 0
    k = n // N
    return Grouping(tuple(j // k for j in range(n)))


def random_grouping(n: int, N: int, seed: int) -> Grouping:
    """Uniform random equal-size grouping (the paper's S)."""
    assert n % N == 0
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    a = np.empty(n, np.int64)
    a[perm] = np.arange(n) // (n // N)
    return Grouping(tuple(a))


def _check_divides(n: int, N: int) -> None:
    if N < 1 or n % N:
        raise ValueError(f"{n} workers do not split into {N} equal groups")


def group_iid(labels: Sequence[int], N: int) -> Grouping:
    """Spread each label across groups round-robin => upward divergence ~ 0
    (the paper's 'group-IID' construction, Fig. 3c)."""
    labels = np.asarray(labels)
    order = np.argsort(labels, kind="stable")
    a = np.empty(len(labels), np.int64)
    a[order] = np.arange(len(labels)) % N
    return Grouping(tuple(a))


def group_noniid(labels: Sequence[int], N: int) -> Grouping:
    """Pack similar labels into the same group => large upward divergence
    (the paper's 'group-non-IID' construction)."""
    labels = np.asarray(labels)
    n = len(labels)
    _check_divides(n, N)
    order = np.argsort(labels, kind="stable")
    a = np.empty(n, np.int64)
    a[order] = np.arange(n) // (n // N)
    return Grouping(tuple(a))


def diversity_grouping(grads: np.ndarray, N: int) -> Grouping:
    """Remark 2 made operational: the grouping with the SMALLEST upward
    divergence, by making each group internally diverse.

    grads: (n, dim) per-worker gradients at a common point.  Greedy
    balanced assignment: workers sorted by distance from the global mean
    (farthest first) go to the group whose running mean is pulled closest
    to the global mean by accepting them."""
    g = np.asarray(grads, np.float64)
    n, dim = g.shape
    _check_divides(n, N)
    k = n // N
    gbar = g.mean(0)
    order = np.argsort(-np.linalg.norm(g - gbar, axis=1))  # farthest first
    sums = np.zeros((N, dim))
    counts = np.zeros(N, np.int64)
    assign = np.empty(n, np.int64)
    for j in order:
        best, best_cost = None, None
        for i in range(N):
            if counts[i] >= k:
                continue
            mean_i = (sums[i] + g[j]) / (counts[i] + 1)
            cost = float(np.linalg.norm(mean_i - gbar))
            if best is None or cost < best_cost:
                best, best_cost = i, cost
        assign[j] = best
        sums[best] += g[j]
        counts[best] += 1
    return Grouping(tuple(assign))


def sample_participation(grouping_or_sizes, frac: float,
                         seed: int) -> np.ndarray:
    """Uniform per-group worker sampling (paper Appendix E partial
    participation): each group contributes max(1, round(frac * n_i))
    participants.  ``grouping_or_sizes`` is a Grouping or, for a uniform
    hierarchy, (N, K) contiguous groups.  Returns a bool (n,) mask."""
    if isinstance(grouping_or_sizes, Grouping):
        groups = [grouping_or_sizes.members(i)
                  for i in range(grouping_or_sizes.N)]
        n = grouping_or_sizes.n
    else:
        N, K = grouping_or_sizes
        groups = [np.arange(i * K, (i + 1) * K) for i in range(N)]
        n = N * K
    rng = np.random.default_rng(seed)
    mask = np.zeros(n, bool)
    for members in groups:
        k = max(1, int(round(frac * len(members))))
        mask[rng.choice(members, size=k, replace=False)] = True
    return mask
