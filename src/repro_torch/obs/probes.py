"""In-round divergence probes: the paper's telemetry measured on the device
(PyTorch counterpart of ``repro.obs.probes``).

The paper's analysis runs through the eq. (10) partition — global
parameter divergence = upward (between level-ℓ subtree means) + downward
(within subtrees).  This module takes that measurement inside the round
body:

* a :class:`Metrics` plan (``EngineConfig(metrics=...)``, resolved through
  :func:`make_metrics`: None = off, the bit-for-bit default) decides WHAT
  is probed — per-level parameter divergences at every
  :class:`~repro_torch.core.topology.SyncEvent`, and a per-step
  ``grad_norm`` channel folded into the local-update metrics;
* a :class:`MetricBuffer` ring (carried in ``HSGDState.metrics``) holds one
  probe row per sync event on the state's device, so the round body reads
  nothing back to the host; ``run_rounds`` drains it with ONE
  device-to-host copy at eval boundaries, before the ring would wrap and
  at the end, and gives each row its (step, level) back from the schedule;
* :meth:`Metrics.sim_row_fn` evaluates the eq. (10) partition
  (:func:`repro_torch.core.divergence.partition_divergences_tree`) on the
  in-array worker block of the sim executor.  The mesh lowering
  (``mesh_row_fn``) is ROADMAP A7d.

The probe measures PARAM divergences on the pre-aggregation worker params
(the states already resident when the sync fires).

In the eager port the ring's ``count`` is a host ``int``: the reference
keeps it on the device only because its round body is jitted, and a
device-side ``count % capacity`` would cost a host sync per push.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.core.divergence import (partition_constants,
                                         partition_divergences_tree)
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class MetricBuffer:
    """Ring of probe rows on the state's device: ``rows`` is (capacity, k)
    float32, ``count`` the number of pushes since the last drain (a host
    int).  Rows don't carry their step/level — the drain reconstructs both
    from the static schedule."""
    rows: torch.Tensor   # (capacity, k) f32
    count: int = 0

    @classmethod
    def zeros(cls, capacity: int, k: int, device=None) -> "MetricBuffer":
        return cls(torch.zeros((capacity, max(k, 1)), dtype=torch.float32,
                               device=device), 0)

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    def push(self, row: torch.Tensor) -> "MetricBuffer":
        """Append one probe row (wraps at capacity — the engine drains
        before that ever happens).  Writes into a copy of ``rows``, so a
        buffer held elsewhere (an earlier state) keeps its rows."""
        rows = self.rows.clone()
        rows[self.count % self.capacity] = row.reshape(-1).to(rows.dtype)
        return MetricBuffer(rows, self.count + 1)

    def reset(self) -> "MetricBuffer":
        """Post-drain buffer: same storage, count back to zero (later
        pushes overwrite the rows; no device work to clear them)."""
        return MetricBuffer(self.rows, 0)


@dataclasses.dataclass(frozen=True)
class Metrics:
    """The resolved observability plan, bound per engine
    (``EngineConfig(metrics=...)`` through :func:`make_metrics`).

    divergences: push the per-level divergence row at every sync event.
    grad_norm:   add a worker-mean gradient-l2-norm channel to the per-step
                 training metrics (rides the existing metric transfer).
    capacity:    probe-buffer rows between forced drains.
    staleness:   append the async stale-sync channel to the probe row
                 (``div_staleness``): at every stale level-l boundary that
                 folds, the worker-mean ‖applied − fresh‖² between the
                 delta-corrected params and the codec-free barrier
                 aggregate of the pre-fold params.  0 at fresh events,
                 warm-up and flush boundaries.  Engines with
                 ``async_levels`` enable it automatically when divergence
                 probing is on.
    """
    divergences: bool = True
    grad_norm: bool = True
    capacity: int = 256
    staleness: bool = False

    def __post_init__(self):
        assert self.capacity >= 1, self

    # -- channel layout ------------------------------------------------------
    def levels(self, topology) -> Tuple[int, ...]:
        """The internal levels probed (keys of ``level_groupings``)."""
        return tuple(sorted(topology.level_groupings()))

    def channels(self, topology) -> Tuple[str, ...]:
        """Probe-row layout: global divergence first, then (upward,
        downward) per internal level, matching eq. (10)'s partition — plus
        the trailing ``staleness`` channel when enabled (the executor
        composes it into the row at push time)."""
        out = ["global"]
        for lvl in self.levels(topology):
            out += [f"up_L{lvl}", f"down_L{lvl}"]
        if self.staleness:
            out.append("staleness")
        return tuple(out)

    def history_keys(self, topology) -> Tuple[str, ...]:
        """The per-step history keys the drained rows merge in under."""
        return tuple(f"div_{c}" for c in self.channels(topology))

    def init_buffer(self, topology, device=None) -> MetricBuffer:
        return MetricBuffer.zeros(self.capacity,
                                  len(self.channels(topology)), device)

    # -- the probe lowerings --------------------------------------------------
    def sim_row_fn(self, topology) -> Callable[[Any], torch.Tensor]:
        """In-array probe for the sim executor: the eq. (10) partition
        (:func:`repro_torch.core.divergence.partition_divergences_tree`) on
        the (n, ...) worker params, with the leaves concatenated into one
        (n, dim) float32 block first so that a row is a dozen launches
        whatever the leaf count, and with the grouping constants built
        once per device (no host-to-device copy per row).  Equal to the
        reference's leaf-by-leaf row up to float32 summation order."""
        groupings = topology.level_groupings()
        ordered = [groupings[lvl] for lvl in self.levels(topology)]
        consts: Dict[torch.device, Dict] = {}

        def row(params) -> torch.Tensor:
            leaves = tree_leaves(params)
            x = torch.cat([l.reshape(l.shape[0], -1).to(torch.float32)
                           for l in leaves], dim=1)
            dev = x.device
            if dev not in consts:
                consts[dev] = partition_constants(ordered, dev)
            return partition_divergences_tree({"x": x}, ordered,
                                              consts[dev])

        return row

    def mesh_row_fn(self, topology, rep_axes=None):
        """The named-axis probe of the mesh executor is ROADMAP A7d."""
        raise NotImplementedError(
            "the mesh executor's divergence probe is not ported yet "
            "(ROADMAP A7d): run probes on the sim executor, or disable "
            "divergence probing (Metrics(divergences=False))")

    # -- the overhead contract ----------------------------------------------
    def op_budget(self, backend: str, topology, n_param_leaves: int) -> int:
        """Max extra aggregation/probe ops a metrics-on round body may add
        vs its metrics-off twin, as the reference counts them in a jaxpr
        (rule R6, copied unchanged; the port has no audit engine yet,
        ROADMAP A11, so the number is recorded, not enforced).

        mesh: the divergence probe is exactly L+2 collectives per sync
        (L internal levels) and the ``grad_norm`` channel one extra metric
        mean.  sim: 3 in-array reduces per leaf for the global term and 3
        per leaf x level — 3·leaves·(1+L) — plus one sum-of-squares reduce
        per param leaf for ``grad_norm``."""
        L = len(self.levels(topology))
        budget = 0
        if backend == "mesh":
            if self.divergences:
                budget += L + 2
            if self.grad_norm:
                budget += 1
            if self.staleness:
                # per stale boundary: one fresh shard_aggregate collective
                # per param leaf + the final worker-mean pmean
                budget += n_param_leaves + 1
        else:
            if self.divergences:
                budget += 3 * n_param_leaves * (1 + L)
            if self.grad_norm:
                budget += n_param_leaves + 1
            if self.staleness:
                # per stale boundary: the codec-free fresh aggregate (one
                # in-array mean per leaf), a squared-norm row sum per leaf,
                # and the final worker mean
                budget += 2 * n_param_leaves + 1
        return budget


MetricsLike = Union[Metrics, str, bool, None]


def make_metrics(spec: MetricsLike = None, **kwargs):
    """Resolve the ``EngineConfig(metrics=...)`` argument: None/False = off
    (the bit-for-bit default — no buffer in the state, no probe in the
    round body), ``True``/``"on"`` = the default :class:`Metrics` plan, or
    a ready instance."""
    if spec is None or spec is False:
        assert not kwargs, "kwargs only apply when constructing a plan"
        return None
    if isinstance(spec, Metrics):
        assert not kwargs, "kwargs only apply when constructing a plan"
        return spec
    assert spec is True or (isinstance(spec, str) and spec.lower() == "on"), \
        f"metrics must be a Metrics plan, 'on', True or None; got {spec!r}"
    return Metrics(**kwargs)
