"""Deployment planner: turn Theorem 2 into an actionable (N, G, I) choice.

The paper's conclusion promises "valuable insights into the design of
practical H-SGD systems, including the choice of global and local
aggregation periods".  This module makes that concrete: given the problem
constants (L, sigma^2, eps~^2, f0-f*), the fleet (n workers, valid group
counts), a training horizon T and a communication-cost model (seconds per
local / global aggregation round + per-step compute), enumerate the valid
(N, G, I) grid and return the configuration minimizing the Theorem-2 bound
subject to a wall-clock budget — or minimizing wall-clock subject to a bound
target.  Numpy-only: a copy of ``repro.core.planner`` on the port's
``theory``, held bit for bit to it by the tests.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import theory


@dataclasses.dataclass(frozen=True)
class CommModel:
    """Seconds per event (paper Table E.1 measured near/far rounds)."""
    compute_s: float          # one local SGD iteration
    local_round_s: float      # one intra-group aggregation (near)
    global_round_s: float     # one global aggregation (far)

    def wall_clock(self, T: int, G: int, I: int) -> float:
        n_glob = T // G
        n_loc = T // I - n_glob   # local rounds subsumed by global ones
        return T * self.compute_s + n_loc * self.local_round_s \
            + n_glob * self.global_round_s

    @classmethod
    def fit_from_trace(cls, history: Sequence[Dict],
                       topology) -> "CommModel":
        """Least-squares fit of the three constants from a simulated (or
        measured) run: ``history`` is :meth:`repro_torch.core.HSGD.run_rounds`
        output whose records carry ``sim_time_s`` (any trace with ``t`` +
        cumulative seconds works), ``topology`` the
        :class:`~repro.core.topology.Topology` (or anything with
        ``schedule(T)``) that produced it.  Each record contributes one
        equation  ``time(t) ~= t*compute + n_loc(t)*local + n_glob(t)*
        global``  with the event counts read off the schedule (levels >= 2
        lumped as "local", level 1 as "global"); the solution is clipped at
        zero.  This closes the loop runtime -> planner: simulate a regime
        once, fit, then :func:`enumerate_plans` prices every (N, G, I)
        under it."""
        import numpy as np
        recs = [r for r in history if "sim_time_s" in r]
        assert recs, "no record carries sim_time_s — run with a runtime " \
                     "model"
        T = max(int(r["t"]) for r in recs)
        # the clock restarts at 0 on every run_rounds call, while record t
        # is absolute — a resumed trace starts at t0 > 0, so regress steps
        # and event counts RELATIVE to the trace's own start, not step 0
        t0 = min(int(r["t"]) for r in recs) - 1
        sched = topology.schedule(T)
        # Topology.schedule yields SyncEvents, HierarchySpec.schedule ints
        lvls = [ev if ev is None or isinstance(ev, int) else ev.level
                for ev in sched]
        n_loc = np.cumsum([l is not None and l >= 2 for l in lvls])
        n_glob = np.cumsum([l == 1 for l in lvls])
        loc0 = n_loc[t0 - 1] if t0 else 0
        glob0 = n_glob[t0 - 1] if t0 else 0
        A = np.array([[r["t"] - t0,
                       n_loc[int(r["t"]) - 1] - loc0,
                       n_glob[int(r["t"]) - 1] - glob0]
                      for r in recs], float)
        y = np.array([r["sim_time_s"] for r in recs], float)
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        c, lo, gl = (max(float(v), 0.0) for v in coef)
        return cls(compute_s=c, local_round_s=lo, global_round_s=gl)


@dataclasses.dataclass(frozen=True)
class PlanPoint:
    N: int
    G: int
    I: int
    bound: float
    wall_s: float
    gamma: float


def enumerate_plans(*, n: int, T: int, L: float, sigma2: float,
                    eps_tilde2: float, f0_minus_fstar: float,
                    comm: CommModel,
                    Gs: Sequence[int] = (8, 16, 32, 64, 128, 256),
                    Is: Sequence[int] = (1, 2, 4, 8, 16, 32),
                    Ns: Optional[Sequence[int]] = None) -> List[PlanPoint]:
    if Ns is None:
        Ns = [N for N in range(2, n) if n % N == 0]
    out = []
    for N in Ns:
        for G in Gs:
            for I in Is:
                if I > G or G % I:
                    continue
                gamma = 0.9 * theory.lr_cap(G, L)
                b = theory.theorem2_bound(
                    gamma=gamma, T=T, L=L, sigma2=sigma2,
                    f0_minus_fstar=f0_minus_fstar, n=n, N=N, G=G, I=I,
                    eps_tilde2=eps_tilde2)
                out.append(PlanPoint(N, G, I, b, comm.wall_clock(T, G, I),
                                     gamma))
    return out


def best_under_budget(plans: Sequence[PlanPoint],
                      wall_budget_s: float) -> Optional[PlanPoint]:
    """Tightest bound among plans meeting the wall-clock budget."""
    ok = [p for p in plans if p.wall_s <= wall_budget_s]
    return min(ok, key=lambda p: p.bound) if ok else None


def fastest_under_bound(plans: Sequence[PlanPoint],
                        bound_target: float) -> Optional[PlanPoint]:
    """Cheapest wall-clock among plans meeting a bound target."""
    ok = [p for p in plans if p.bound <= bound_target]
    return min(ok, key=lambda p: p.wall_s) if ok else None


def pareto_front(plans: Sequence[PlanPoint]) -> List[PlanPoint]:
    """(wall_s, bound) Pareto-efficient plans, sorted by wall_s."""
    pts = sorted(plans, key=lambda p: (p.wall_s, p.bound))
    front: List[PlanPoint] = []
    best = math.inf
    for p in pts:
        if p.bound < best - 1e-15:
            front.append(p)
            best = p.bound
    return front
