"""Straggler samplers: per-worker compute-time multipliers, step by step.

Heterogeneity is what makes the paper's wall-clock argument interesting —
Castiglia et al.'s multi-level analysis (PAPERS.md) explicitly targets
hierarchical networks whose workers do NOT run in lockstep.  A sampler
answers one question: "how much slower than nominal is worker j at step t?"
as an (n,) multiplier vector (1.0 = nominal speed).

Design invariant — **policy-independent draws**: ``multipliers(t)`` is a
pure function of ``(seed, t)`` (the bursty Markov chain evolves from the
seed as a function of t only, never of what the engine did with earlier
draws).  Two runs over the same schedule therefore see bit-identical
compute times regardless of participation policy, which is what makes
"deadline-elastic is never slower than full-barrier" an exact, assertable
invariant (see :mod:`repro_torch.runtime.clock`) instead of a statistical one.

Three regimes (registry ``STRAGGLERS`` / :func:`make_straggler`):

* ``fixed``     — a fixed random subset of workers is permanently ``factor``
                  times slower (the classic dedicated-slow-node regime);
* ``lognormal`` — i.i.d. per-(worker, step) lognormal jitter with unit mean
                  (heavy-tailed OS/network noise);
* ``bursty``    — a two-state Markov chain per worker (nominal <-> slow),
                  modeling transient contention bursts.
"""
from __future__ import annotations

import abc
from typing import Dict, List, Optional, Union

import numpy as np


def _rng(seed: int, *ctx: int) -> np.random.Generator:
    """Counter-based generator: a fresh, deterministic stream per (seed,
    context) tuple — draws never depend on call order."""
    return np.random.default_rng([0x5712A6, int(seed)] + [int(c) for c in ctx])


class StragglerSampler(abc.ABC):
    """(n, seed)-bound sampler of per-worker compute multipliers."""

    def __init__(self, n: int, seed: int = 0):
        assert n >= 1
        self.n = int(n)
        self.seed = int(seed)

    @abc.abstractmethod
    def multipliers(self, t: int) -> np.ndarray:
        """(n,) positive float64 multipliers for the local update of step
        ``t`` (0-indexed); a pure function of ``(seed, t)``."""

    def rebind(self, n: int, seed: int) -> "StragglerSampler":
        """Same regime, different world (the RuntimeModel carries a template
        sampler; the clock rebinds it to the topology's n and run seed)."""
        return type(self)(n, seed, **self.params())

    def params(self) -> Dict:
        return {}

    def __repr__(self):
        kv = ", ".join(f"{k}={v}" for k, v in self.params().items())
        return f"{type(self).__name__}(n={self.n}, seed={self.seed}" + \
            (f", {kv})" if kv else ")")


class NoStraggler(StragglerSampler):
    """Homogeneous fleet: every worker at nominal speed every step."""

    def multipliers(self, t: int) -> np.ndarray:
        return np.ones(self.n)


class FixedSlowStraggler(StragglerSampler):
    """A seed-chosen fraction of workers is permanently ``factor``x slower."""

    def __init__(self, n: int, seed: int = 0, frac: float = 0.25,
                 factor: float = 4.0):
        super().__init__(n, seed)
        assert 0.0 <= frac <= 1.0 and factor >= 1.0
        self.frac = float(frac)
        self.factor = float(factor)
        k = int(round(self.frac * n))
        slow = _rng(self.seed, 1).choice(n, size=k, replace=False)
        self.slow_set = np.zeros(n, bool)
        self.slow_set[slow] = True

    def params(self) -> Dict:
        return {"frac": self.frac, "factor": self.factor}

    def multipliers(self, t: int) -> np.ndarray:
        return np.where(self.slow_set, self.factor, 1.0)


class LognormalStraggler(StragglerSampler):
    """i.i.d. lognormal jitter per (worker, step), mean exactly 1.0
    (``exp(sigma*z - sigma^2/2)``), so the FLEET's nominal throughput is
    unchanged and only the tail stretches."""

    def __init__(self, n: int, seed: int = 0, sigma: float = 0.5):
        super().__init__(n, seed)
        assert sigma >= 0.0
        self.sigma = float(sigma)

    def params(self) -> Dict:
        return {"sigma": self.sigma}

    def multipliers(self, t: int) -> np.ndarray:
        z = _rng(self.seed, 2, t).standard_normal(self.n)
        return np.exp(self.sigma * z - 0.5 * self.sigma * self.sigma)


class BurstyStraggler(StragglerSampler):
    """Two-state Markov chain per worker: nominal -> slow with ``p_enter``,
    slow -> nominal with ``p_exit``; slow state is ``factor``x.  The chain
    state at step t is computed (and cached) by evolving from t=0 with
    per-step counter-based uniforms, so it is a pure function of (seed, t)
    — never of the call sequence."""

    def __init__(self, n: int, seed: int = 0, p_enter: float = 0.05,
                 p_exit: float = 0.3, factor: float = 6.0):
        super().__init__(n, seed)
        assert 0.0 <= p_enter <= 1.0 and 0.0 < p_exit <= 1.0 and factor >= 1.0
        self.p_enter = float(p_enter)
        self.p_exit = float(p_exit)
        self.factor = float(factor)
        self._states: List[np.ndarray] = [np.zeros(n, bool)]  # state BEFORE t

    def params(self) -> Dict:
        return {"p_enter": self.p_enter, "p_exit": self.p_exit,
                "factor": self.factor}

    def _state(self, t: int) -> np.ndarray:
        while len(self._states) <= t:
            k = len(self._states)
            u = _rng(self.seed, 3, k).random(self.n)
            prev = self._states[-1]
            nxt = np.where(prev, u >= self.p_exit, u < self.p_enter)
            self._states.append(nxt)
        return self._states[t]

    def multipliers(self, t: int) -> np.ndarray:
        return np.where(self._state(t), self.factor, 1.0)


# ---------------------------------------------------------------------------
# registry / factory — mirrors make_topology / make_aggregator
# ---------------------------------------------------------------------------
STRAGGLERS = {
    "none": NoStraggler,
    "fixed": FixedSlowStraggler,
    "lognormal": LognormalStraggler,
    "bursty": BurstyStraggler,
}

StragglerLike = Union[str, StragglerSampler, None]


def register_straggler(name: str, cls) -> None:
    STRAGGLERS[name.lower()] = cls


def make_straggler(spec: StragglerLike, n: int,
                   seed: int = 0) -> StragglerSampler:
    """Resolve a sampler from an instance, a registry name, or a CLI spec
    string ``"name[:pos1[:pos2...]]"`` with positional float parameters in
    declaration order, e.g. ``"fixed:0.25:4"`` (frac, factor),
    ``"lognormal:0.8"`` (sigma), ``"bursty:0.05:0.3:6"``.  None -> no
    stragglers (homogeneous fleet)."""
    if spec is None:
        return NoStraggler(n, seed)
    if isinstance(spec, StragglerSampler):
        return spec.rebind(n, seed)
    name, _, rest = str(spec).partition(":")
    name = name.lower()
    if name not in STRAGGLERS:
        raise KeyError(
            f"unknown straggler regime {name!r}; known: {sorted(STRAGGLERS)}")
    cls = STRAGGLERS[name]
    if not rest:
        return cls(n, seed)
    fields = [f for f in cls(2).params()]  # declaration order
    vals = [float(x) for x in rest.split(":")]
    if len(vals) > len(fields):
        raise ValueError(f"{name} takes at most {len(fields)} parameters "
                         f"({fields}), got {vals}")
    return cls(n, seed, **dict(zip(fields, vals)))
