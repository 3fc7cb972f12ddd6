"""Participation policies: who makes a sync's deadline, as a runtime mask.

A level-ℓ sync is a barrier within each level-(ℓ-1) subtree.  Under
heterogeneity the policy decides how long that barrier holds the door open:

* :class:`FullBarrier` (default) — everybody waits for the slowest member;
  bitwise the classic H-SGD semantics, just with the wait accounted.
* :class:`DeadlineElastic` — the subtree admits workers arriving within
  ``deadline_s(level)`` of an anchor arrival; later arrivals are dropped
  from this event only.  The anchor is a per-subtree quantile (default the
  MEDIAN, ``anchor="median"``), never an absolute clock, so at least one
  participant is always admitted and the weighted group mean is well
  defined.  ``anchor="min"`` (the fastest member) is sharper but fragile:
  a worker that skipped earlier barriers carries a clock LOW relative to
  the barrier-pushed fleet, and on return it would anchor the cutoff so
  low that the bulk of the subtree gets dropped — the median is robust to
  that (at least half the subtree is always admitted).

The policy's output is the repo's existing runtime-mask / partial-
participation contract (``admit`` -> (n,) bool): the clock hands the mask
to the engine, which aggregates over admitted workers only while dropped
workers keep their exact post-update params AND their unconsumed comms
residuals (they transmitted nothing, they received nothing — they were
still computing when the barrier closed).  Both executors honor it
(``Executor._build_round(..., masked=True)``; the mesh applies the drop to
each rank's own row).
"""
from __future__ import annotations

import abc
from typing import Dict, Union

import numpy as np


class ParticipationPolicy(abc.ABC):
    """Per-subtree admission rule for one sync barrier."""

    #: True if this policy can drop workers (its drops route rounds through
    #: the executors' masked variants; full-barrier is pure accounting).
    elastic: bool = False

    @abc.abstractmethod
    def admit(self, level: int, arrivals: np.ndarray) -> np.ndarray:
        """arrivals: (k,) simulated arrival times of ONE aggregation
        subtree's members at a level-``level`` barrier.  Returns (k,) bool —
        the members admitted to this event."""


class FullBarrier(ParticipationPolicy):
    """Everyone syncs; the barrier waits for the slowest member."""

    def admit(self, level: int, arrivals: np.ndarray) -> np.ndarray:
        return np.ones(len(arrivals), bool)

    def __repr__(self):
        return "FullBarrier()"


class DeadlineElastic(ParticipationPolicy):
    """Admit workers arriving within ``deadline_s`` of the subtree's anchor
    arrival (default: the median); drop the rest from this event.

    deadline_s: one slack for every level, or a per-level dict
    ``{1: far_slack, 2: near_slack, ...}`` (missing levels fall back to
    ``default``, default inf = full barrier at that level).
    anchor: "median" (robust; at least half the subtree always admitted) or
    "min" (the fastest member; sharper, but see the module docstring).
    """

    elastic = True

    def __init__(self, deadline_s: Union[float, Dict[int, float]],
                 default: float = np.inf, anchor: str = "median"):
        if not isinstance(deadline_s, dict):
            deadline_s = {None: float(deadline_s)}
            default = deadline_s[None]
        self.deadline_s = {k: float(v) for k, v in deadline_s.items()}
        self.default = float(default)
        assert all(v >= 0.0 for v in self.deadline_s.values()) \
            and default >= 0.0, "deadlines are non-negative slacks"
        assert anchor in ("median", "min"), anchor
        self.anchor = anchor

    def deadline(self, level: int) -> float:
        return self.deadline_s.get(level, self.default)

    def admit(self, level: int, arrivals: np.ndarray) -> np.ndarray:
        ref = np.median(arrivals) if self.anchor == "median" \
            else arrivals.min()
        return arrivals <= ref + self.deadline(level)

    def __repr__(self):
        d = {k: v for k, v in self.deadline_s.items() if k is not None}
        return f"DeadlineElastic({d or self.default}, anchor={self.anchor!r})"


PolicyLike = Union[str, float, Dict[int, float], ParticipationPolicy, None]


def make_policy(spec: PolicyLike = None) -> ParticipationPolicy:
    """Resolve a policy: None/"full" -> FullBarrier; a number (or numeric
    string) -> DeadlineElastic with that slack at every level; a per-level
    CLI spec ``"L1:2.0,L2:0.5"`` -> DeadlineElastic({1: 2.0, 2: 0.5})."""
    if spec is None:
        return FullBarrier()
    if isinstance(spec, ParticipationPolicy):
        return spec
    if isinstance(spec, dict):
        return DeadlineElastic(spec)
    if isinstance(spec, (int, float)):
        return DeadlineElastic(float(spec))
    s = str(spec).strip()
    if s.lower() in ("full", "barrier", "full_barrier"):
        return FullBarrier()
    try:
        return DeadlineElastic(float(s))
    except ValueError:
        pass
    per_level: Dict[int, float] = {}
    for part in s.split(","):
        lvl, _, val = part.partition(":")
        lvl = lvl.strip().lstrip("Ll")
        if not lvl.isdigit() or not val:
            raise ValueError(
                f"bad deadline spec {spec!r}; want a slack in seconds "
                f"('2.0') or per-level 'L1:2.0,L2:0.5'")
        per_level[int(lvl)] = float(val)
    return DeadlineElastic(per_level)
