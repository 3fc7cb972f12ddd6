"""Two-level worker groupings (paper §3, §4.3).

Numpy-only: the part of ``repro.core.grouping`` the H-SGD path needs
(``Grouping``, ``contiguous``, ``random_grouping``), copied and held equal
to it by the tests.  A ``Grouping`` is an explicit assignment of n workers
to N groups (possibly non-uniform, as Theorem 1 allows).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grouping:
    assignment: tuple  # length n, group ids 0..N-1

    def __post_init__(self):
        a = np.asarray(self.assignment)
        assert a.ndim == 1 and a.min() >= 0
        ids = np.unique(a)
        assert (ids == np.arange(len(ids))).all(), "group ids must be dense"

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

    def onehot(self) -> np.ndarray:
        """(N, n) membership indicator."""
        a = np.asarray(self.assignment)
        return (np.arange(self.N)[:, None] == a[None, :]).astype(np.float64)


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
