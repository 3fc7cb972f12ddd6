"""Event-driven simulated time for H-SGD schedules.

The paper's whole argument is convergence per *wall-clock* cost — rare far
rounds win because near rounds are cheap — but the repo priced time as three
static constants (``planner.CommModel``).  This module simulates it:

* every worker carries its own clock, advanced per local step by
  ``compute_s`` x a :mod:`straggler <repro_torch.runtime.stragglers>` multiplier;
* every :class:`~repro_torch.core.topology.SyncEvent` is a barrier within each
  level-(ℓ-1) subtree, priced by per-level :class:`LinkModel`s —
  ``latency_s + payload_bytes / bandwidth`` per tree tier crossed, with
  ``payload_bytes`` the per-worker encoded payload from the wire
  accounting (:class:`repro_torch.comms.wire.WireStats`), so compression codecs
  visibly buy simulated time;
* the bound :mod:`participation policy <repro_torch.runtime.elastic>` decides who
  makes each barrier; drops become the engine's runtime-mask contract.

Everything is host-side numpy — zero device work, zero effect on the
round bodies (``HSGD(..., runtime=None)``, the default, is bitwise-identical to
no runtime at all; with a runtime and the default full-barrier policy the
*trajectory* is still bitwise-identical, only the accounting is added).

Two exact invariants, by construction (and property-tested):

1. **Monotone**: per-worker clocks never decrease (barriers only wait,
   drops keep the dropped worker's own later arrival).
2. **Elastic never slower**: with the same seed (so the same compute
   draws — samplers are pure in ``(seed, t)``), every worker's clock under
   ``DeadlineElastic`` is <= its clock under ``FullBarrier`` at every step:
   admitted workers wait for a subset (max over fewer arrivals), dropped
   workers keep an arrival that full-barrier would have raised past the
   global max anyway.  Induction gives the pointwise bound;
   ``repro_torch.experiments.bench_runtime`` asserts it per straggler
   regime.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.runtime.elastic import (ParticipationPolicy, PolicyLike,
                                   make_policy)
from repro_torch.runtime.stragglers import (StragglerLike, StragglerSampler,
                                      make_straggler)


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One hierarchy tier's uplink: latency + bandwidth.  A sync payload
    crossing this tier costs ``latency_s + nbytes / bandwidth_Bps``."""
    latency_s: float
    bandwidth_Bps: float = np.inf   # bytes/second

    def __post_init__(self):
        assert self.latency_s >= 0.0 and self.bandwidth_Bps > 0.0, self

    def sync_s(self, nbytes: int) -> float:
        return self.latency_s + float(nbytes) / self.bandwidth_Bps


def default_links(num_levels: int) -> Tuple[LinkModel, ...]:
    """A plausible datacenter-ish ladder: the outermost tier (level 1, the
    cross-pod / WAN fabric) is slow, each deeper tier 10x faster — the
    near-vs-far asymmetry the paper's Table E.1 measures."""
    return tuple(LinkModel(latency_s=0.1 * 10.0 ** -(l - 1),
                           bandwidth_Bps=1e8 * 10.0 ** (l - 1))
                 for l in range(1, num_levels + 1))


@dataclasses.dataclass(frozen=True)
class RuntimeModel:
    """The engine-facing bundle: ``HSGD(..., runtime=RuntimeModel(...))``.

    compute_s:  nominal seconds per local update (scaled per worker/step by
                the straggler sampler).
    links:      one :class:`LinkModel` per hierarchy level, level 1 first
                (None -> :func:`default_links` for the bound topology).
    straggler:  sampler instance / registry spec ("fixed:0.25:4" ...) /
                None (homogeneous).
    policy:     participation policy / deadline spec ("2.0", "L1:2.0,L2:0.5",
                a number) / None (full barrier).
    seed:       sampler seed (pure counter-based draws — see stragglers.py).
    """
    compute_s: float = 1.0
    links: Optional[Tuple[LinkModel, ...]] = None
    straggler: StragglerLike = None
    policy: PolicyLike = None
    seed: int = 0

    def __post_init__(self):
        assert self.compute_s > 0.0, self

    @property
    def elastic(self) -> bool:
        return make_policy(self.policy).elastic

    def clock(self, topology, payload_bytes: int,
              recorder=None, async_levels=None) -> "SimClock":
        """Bind to a topology + per-worker payload size -> a fresh clock.
        ``recorder`` (duck-typed, the reference's ``TraceRecorder``
        interface; the port has none yet, so it stays None until ROADMAP
        A7b) gets per-worker compute/wait spans and per-subtree sync spans
        in simulated time.
        ``async_levels`` ({level: staleness}) prices those levels' syncs
        as stale (non-barrier) boundaries — see :meth:`SimClock.sync`."""
        return SimClock(self, topology, payload_bytes, recorder,
                        async_levels=async_levels)


RuntimeLike = Union[RuntimeModel, None]


def make_runtime(spec: RuntimeLike = None, **kwargs) -> Optional[RuntimeModel]:
    """Resolve the ``HSGD(..., runtime=...)`` argument (None = off, the
    bitwise-identical default)."""
    if spec is None and not kwargs:
        return None
    if isinstance(spec, RuntimeModel):
        assert not kwargs, "kwargs only apply when constructing from scratch"
        return spec
    assert spec is None, f"runtime must be a RuntimeModel or None, got {spec!r}"
    return RuntimeModel(**kwargs)


class SimClock:
    """Per-worker simulated clocks over one topology's schedule.

    The engine drives it with ``advance(t)`` (one local update everywhere)
    and ``sync(event)`` (one barrier; returns the (n,) participation mask,
    or None when nobody was dropped).  ``time_s`` is the makespan (max over
    worker clocks); ``comm_s`` attributes barrier link time per level
    (parallel subtrees overlap, so each event counts its link cost once).
    """

    def __init__(self, model: RuntimeModel, topology, payload_bytes: int,
                 recorder=None, async_levels=None):
        self.model = model
        self.topology = topology
        self.payload_bytes = int(payload_bytes)
        self.recorder = recorder  # optional trace recorder (duck-typed)
        # stale-sync pricing: a level in async_levels never barriers its own
        # boundary — workers keep computing while the aggregate is in flight,
        # and only wait (at a later boundary) for the oldest outstanding
        # aggregate to become available.  One queued (n,) availability-time
        # vector per outstanding aggregate, oldest first.
        self.async_levels: Dict[int, int] = \
            {int(l): int(s) for l, s in (async_levels or {}).items()
             if int(s) > 0}
        self._stale_avail: Dict[int, List[np.ndarray]] = \
            {l: [] for l in self.async_levels}
        # per-worker clocks at the previous level-ℓ stale boundary: admission
        # there is judged on arrival INCREMENTS since that boundary — the
        # barrier path's policy sees per-period compute (everyone leaves a
        # barrier synchronized), and anchoring the async policy on raw
        # clocks instead would turn one transient burst into a permanent
        # offset and thus permanent exclusion
        self._stale_origin: Dict[int, np.ndarray] = \
            {l: np.zeros(topology.n) for l in self.async_levels}
        self.n = topology.n
        self.num_levels = len(topology.periods)
        links = model.links if model.links is not None \
            else default_links(self.num_levels)
        assert len(links) == self.num_levels, \
            f"need one LinkModel per hierarchy level ({self.num_levels}), " \
            f"got {len(links)}"
        self.links = tuple(links)
        self.sampler: StragglerSampler = make_straggler(
            model.straggler, self.n, model.seed)
        self.policy: ParticipationPolicy = make_policy(model.policy)
        # level-ℓ barrier groups = the level-(ℓ-1) subtrees
        groupings = topology.level_groupings()
        self._subtrees: Dict[int, List[np.ndarray]] = {
            1: [np.arange(self.n)]}
        for lvl, g in groupings.items():
            self._subtrees[lvl + 1] = [g.members(i) for i in range(g.N)]
        self.clocks = np.zeros(self.n)
        self.compute_s = np.zeros(self.n)   # per-worker compute total
        self.wait_s = np.zeros(self.n)      # per-worker barrier-wait total
        self.comm_s = {l: 0.0 for l in range(1, self.num_levels + 1)}
        self.n_dropped = {l: 0 for l in range(1, self.num_levels + 1)}
        self.n_synced = {l: 0 for l in range(1, self.num_levels + 1)}
        # per level: who made the most recent event, and when its (slowest
        # participating) barrier completed — the "published model" telemetry:
        # right after a level-1 sync, the admitted workers all hold the
        # global aggregate, available at last_sync_time[1] regardless of
        # where the dropped stragglers' clocks are
        self.last_admitted: Dict[int, np.ndarray] = {}
        self.last_sync_time: Dict[int, float] = {}

    # -- time queries --------------------------------------------------------
    @property
    def time_s(self) -> float:
        """Simulated makespan: the slowest worker's clock."""
        return float(self.clocks.max())

    def event_cost_s(self, level: int) -> float:
        """Static link time of one level-``level`` sync: the payload crosses
        every tree tier ``level..M`` on the way up (the wire model's cost
        structure, priced per tier)."""
        return sum(self.links[j - 1].sync_s(self.payload_bytes)
                   for j in range(level, self.num_levels + 1))

    # -- the two engine hooks ------------------------------------------------
    def advance(self, t: int) -> None:
        """One local update of step ``t`` on every worker."""
        dt = self.model.compute_s * self.sampler.multipliers(t)
        if self.recorder is not None:
            for w in range(self.n):
                self.recorder.compute_span(w, float(self.clocks[w]),
                                           float(dt[w]))
        self.clocks += dt
        self.compute_s += dt

    def sync(self, event) -> Optional[np.ndarray]:
        """One sync boundary for ``event``.  Returns the (n,) bool
        participation mask when the policy dropped someone, else None
        (everyone synced — the engine runs its unmasked fast path).

        Levels in ``async_levels`` are priced as stale (non-barrier)
        boundaries: workers are admitted/dropped on their *pre-fold*
        arrivals, admitted workers wait only until the *oldest outstanding*
        level-ℓ aggregate is available (none during warm-up), and the
        boundary posts a new aggregate available at
        ``max(post-fold admitted clocks in the subtree) + event_cost_s(ℓ)``
        — the link time overlaps the next local block instead of stalling
        it.  A more-global event first flushes every deeper async level
        (the plan folds all outstanding aggregates there): conservatively,
        all workers wait for the flushed aggregates before the barrier.
        """
        for l in sorted(self.async_levels, reverse=True):
            if event.level < l:
                self._flush_async(l)
        if event.level in self.async_levels:
            return self._async_sync(event)
        return self._barrier_sync(event)

    def _barrier_sync(self, event) -> Optional[np.ndarray]:
        part = self.topology.participants(event)
        subtrees = self._subtrees.get(event.level)
        if subtrees is None:
            raise ValueError(
                f"no barrier structure for level {event.level} on "
                f"{type(self.topology).__name__} (levels: "
                f"{sorted(self._subtrees)})")
        cost = self.event_cost_s(event.level)
        mask = np.ones(self.n, bool)
        admitted_all = np.zeros(self.n, bool)
        t_done = 0.0
        dropped_any = False
        for members in subtrees:
            if part is not None:
                members = members[part[members]]
                if len(members) == 0:
                    continue   # non-participating group: no barrier, no cost
            arrivals = self.clocks[members]
            made = self.policy.admit(event.level, arrivals)
            assert made.any(), \
                "policy admitted nobody (DeadlineElastic anchors on a " \
                "subtree arrival quantile, so this cannot happen there)"
            if not made.all():
                dropped_any = True
                mask[members[~made]] = False
            admitted = members[made]
            t_sync = arrivals[made].max() + cost
            if self.recorder is not None:
                barrier_open = float(arrivals[made].max())
                self.recorder.sync_span(
                    event.level, barrier_open, cost,
                    payload_bytes=self.payload_bytes,
                    dropped=int((~made).sum()))
                for w, arr in zip(admitted, arrivals[made]):
                    wait = barrier_open - float(arr)
                    if wait > 0.0:
                        self.recorder.wait_span(int(w), event.level,
                                                float(arr), wait)
            self.wait_s[admitted] += t_sync - cost - self.clocks[admitted]
            self.clocks[admitted] = t_sync
            admitted_all[admitted] = True
            t_done = max(t_done, t_sync)
            self.n_synced[event.level] += int(made.sum())
            self.n_dropped[event.level] += int((~made).sum())
        self.comm_s[event.level] += cost
        self.last_admitted[event.level] = admitted_all
        self.last_sync_time[event.level] = t_done
        return mask if dropped_any else None

    def _wait_until(self, avail: np.ndarray, who: np.ndarray, level: int):
        """Advance ``who``-masked worker clocks to at least ``avail`` (the
        (n,) availability times of one in-flight aggregate)."""
        inc = np.where(who, np.maximum(avail - self.clocks, 0.0), 0.0)
        if self.recorder is not None:
            for w in np.nonzero(inc > 0.0)[0]:
                self.recorder.wait_span(int(w), level,
                                        float(self.clocks[w]), float(inc[w]))
        self.wait_s += inc
        self.clocks += inc

    def _flush_async(self, level: int) -> None:
        """Fold every outstanding level-``level`` aggregate: all workers
        wait for the queued availability times (the plan folds them all at
        the next more-global boundary — conservative: nobody proceeds into
        that barrier without the flushed aggregates)."""
        q = self._stale_avail[level]
        everyone = np.ones(self.n, bool)
        while q:
            self._wait_until(q.pop(0), everyone, level)

    def _async_sync(self, event) -> Optional[np.ndarray]:
        """One stale (non-barrier) level-ℓ boundary — see :meth:`sync`.
        On a run resumed mid-schedule (``run_rounds(t0>0)``) the queue
        starts empty, so the first ``staleness`` folds are priced with no
        wait (optimistic by at most ``staleness`` events)."""
        lvl = event.level
        s = self.async_levels[lvl]
        subtrees = self._subtrees.get(lvl)
        if subtrees is None:
            raise ValueError(
                f"no sync structure for level {lvl} on "
                f"{type(self.topology).__name__} (levels: "
                f"{sorted(self._subtrees)})")
        assert self.topology.participants(event) is None, \
            "async levels require full-level events (enforced by the plan)"
        cost = self.event_cost_s(lvl)
        mask = np.ones(self.n, bool)
        admitted_all = np.zeros(self.n, bool)
        dropped_any = False
        # 1) admit on PRE-fold arrival increments since the previous level-ℓ
        #    boundary: the policy judges this period's compute, exactly the
        #    quantity it sees on the barrier path (where every period starts
        #    synchronized) — raw clocks would conflate a worker's whole
        #    straggling history into a permanent offset
        origin = self._stale_origin[lvl]
        for members in subtrees:
            arrivals = self.clocks[members] - origin[members]
            made = self.policy.admit(lvl, arrivals)
            assert made.any(), \
                "policy admitted nobody (DeadlineElastic anchors on a " \
                "subtree arrival quantile, so this cannot happen there)"
            if not made.all():
                dropped_any = True
                mask[members[~made]] = False
            admitted_all[members[made]] = True
            self.n_synced[lvl] += int(made.sum())
            self.n_dropped[lvl] += int((~made).sum())
        # 2) fold wait: once ``staleness`` aggregates are outstanding, the
        #    admitted workers wait for the oldest one (warm-up: no wait)
        q = self._stale_avail[lvl]
        if len(q) >= s:
            self._wait_until(q.pop(0), admitted_all, lvl)
        # 3) post this boundary's aggregate: available per subtree at the
        #    slowest admitted member's (post-fold) clock + link cost —
        #    nobody's clock advances now; the wait happens at the fold
        avail = np.full(self.n, np.inf)
        t_done = 0.0
        for members in subtrees:
            admitted = members[admitted_all[members]]
            t_avail = float(self.clocks[admitted].max()) + cost
            avail[members] = t_avail
            t_done = max(t_done, t_avail)
            if self.recorder is not None:
                self.recorder.sync_span(
                    lvl, t_avail - cost, cost,
                    payload_bytes=self.payload_bytes,
                    dropped=int(len(members) - len(admitted)))
        q.append(avail)
        self._stale_origin[lvl] = self.clocks.copy()
        self.comm_s[lvl] += cost
        self.last_admitted[lvl] = admitted_all
        self.last_sync_time[lvl] = t_done
        return mask if dropped_any else None

    # -- reporting -----------------------------------------------------------
    def level_seconds(self) -> Dict[str, float]:
        """Cumulative per-level barrier link time (each event once — the
        subtrees of one event run in parallel) — the history's
        ``sim_sync_s`` breakdown."""
        return {f"L{l}": round(s, 9) for l, s in self.comm_s.items()}

    def breakdown(self) -> Dict:
        """JSON-able accounting of where the simulated time went."""
        return {
            "time_s": round(self.time_s, 6),
            "compute_s": {"max": round(float(self.compute_s.max()), 6),
                          "mean": round(float(self.compute_s.mean()), 6)},
            "wait_s": {"max": round(float(self.wait_s.max()), 6),
                       "mean": round(float(self.wait_s.mean()), 6)},
            "sync_s": self.level_seconds(),
            "synced": dict(self.n_synced),
            "dropped": dict(self.n_dropped),
            "payload_bytes": self.payload_bytes,
            "event_cost_s": {f"L{l}": round(self.event_cost_s(l), 9)
                             for l in range(1, self.num_levels + 1)},
            **({"async": {f"L{l}": {"staleness": s,
                                    "outstanding": len(self._stale_avail[l])}
                          for l, s in sorted(self.async_levels.items())}}
               if self.async_levels else {}),
        }
