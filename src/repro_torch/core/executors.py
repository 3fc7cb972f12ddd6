"""The executor layer: HOW a compiled H-SGD round runs (PyTorch counterpart
of ``repro.core.executors``).

* :class:`SimExecutor` — the reproduction backend.  One device; ``params``
  carry a leading worker axis, the per-worker update is mapped over it with
  ``torch.func.vmap`` (the counterpart of ``jax.vmap(local_update)``), and
  syncs are in-array means via ``topology.aggregate`` — or, with a comms
  plan, go through the codec's wire path.

The mesh executor (``torch.distributed``, one process per worker) is not
ported yet: ``make_executor("mesh")`` raises, naming ROADMAP A8.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.comms.reduce import SimWireOps
from repro_torch.core.aggregators import Aggregator
from repro_torch.core.hsgd import (HSGDState, Round, _merge_moments,
                                   _moments_only)
from repro_torch.core.topology import SyncEvent
from repro_torch.tree import tree_leaves, tree_map


class Executor(abc.ABC):
    """Backend contract: build (and cache) the step/round bodies for one
    bound plan-layer engine."""

    def __init__(self):
        self.plan = None
        self._step_fns: Dict[Any, Any] = {}
        self._round_fns: Dict[Any, Any] = {}

    def bind(self, plan) -> "Executor":
        """Attach to an :class:`~repro_torch.core.hsgd.HSGD` plan.  One
        executor serves one engine."""
        assert self.plan is None or self.plan is plan, \
            "executor is already bound to another engine"
        self.plan = plan
        return self

    def step_fn(self, event: Optional[SyncEvent], masked: bool = False):
        key = (event, masked)
        if key not in self._step_fns:
            self._step_fns[key] = self._build_step(event, masked)
        return self._step_fns[key]

    def round_fn(self, rnd: Round):
        if rnd not in self._round_fns:
            self._round_fns[rnd] = self._build_round(rnd)
        return self._round_fns[rnd]

    @abc.abstractmethod
    def _build_step(self, event: Optional[SyncEvent], masked: bool = False):
        ...

    @abc.abstractmethod
    def _build_round(self, rnd: Round):
        ...


def _wire_eligible(plan, event: SyncEvent) -> bool:
    """Can this event's sync run as the codec's compressed collective?
    Only the default lowering qualifies — bucketized payloads, a uniform
    hierarchy, the aggregator's stock f32 encode/mean/decode and no static
    per-worker or per-event weights; anything else takes the legacy
    encode→decode→reduce roundtrip.  Runtime masks are supported."""
    comms = plan.comms
    if comms is None or not (comms.wire_reduce and comms.codec.wire_reduce
                             and comms.bucket):
        return False
    topo = plan.topology
    if getattr(topo, "spec", None) is None:       # grouped: segment means
        return False
    if event.groups is not None or event.weights is not None:
        return False
    agg = topo.aggregator
    if type(agg).encode is not Aggregator.encode or \
            type(agg).decode is not Aggregator.decode:
        return False                              # custom wire hooks
    if agg.worker_weights(topo.n) is not None:
        return False                              # weighted means
    return agg.accum_dtype == torch.float32


def _apply_sync(plan, reduce_fn, params, opt_state, wire=None):
    """Apply ``reduce_fn`` (the topology's means) either directly or
    through the comms wire; optimizer moments ride the same path, and the
    optimizer's ``step`` never does.  ``wire`` is the WireOps when the
    event runs as a compressed collective, else None."""
    if plan.comms is None:
        sync = reduce_fn
    else:
        def sync(tree):
            return plan.comms.sync(tree, reduce_fn, reduce_mode=wire)
    params = sync(params)
    moments = _moments_only(opt_state) if plan.aggregate_opt_state else {}
    if tree_leaves(moments):
        opt_state = _merge_moments(opt_state, sync(moments))
    return params, opt_state


def _keep_rows(mask: torch.Tensor, new, old):
    """Row-select on the leading worker axis: mask True -> ``new``, False ->
    ``old``."""
    def sel(a, b):
        return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
    return tree_map(sel, new, old)


class SimExecutor(Executor):
    """n workers on one device; aggregations are reshape means (uniform
    hierarchy) or membership segment means (arbitrary groupings) through
    ``topology.aggregate``, or the codec's wire path with comms on.

    ``step_fn(event, masked=True)`` is Algorithm-1 partial participation: a
    masked-out worker's update is discarded and it still receives the
    aggregate."""

    def _apply_event(self, params, opt_state, event: SyncEvent, mask=None):
        plan = self.plan
        reduce_fn = lambda tree: plan.topology.aggregate(tree, event,
                                                         mask=mask)
        wire = SimWireOps(plan.topology.spec.group_sizes, event.level,
                          mask) if _wire_eligible(plan, event) else None
        new_p, new_o = _apply_sync(plan, reduce_fn, params, opt_state,
                                   wire=wire)
        part = plan.topology.participants(event)
        if plan.comms is not None and part is not None:
            # topology.aggregate keeps non-participants' rows untouched, but
            # the comms path hands it codec-roundtripped payloads — restore
            # the true state of workers a partial-group event did not sync
            keep = torch.as_tensor(part,
                                   device=tree_leaves(params)[0].device)
            new_p = _keep_rows(keep, new_p, params)
            new_o = _keep_rows(keep, new_o, opt_state)
        return new_p, new_o

    def _build_step(self, event: Optional[SyncEvent], masked: bool = False):
        vupdate = torch.func.vmap(self.plan.local_update_fn())

        def step(state: HSGDState, batch, mask=None):
            params, opt_state, metrics = vupdate(state.params,
                                                 state.opt_state, batch)
            if masked:
                # non-participating workers keep their previous state
                params = _keep_rows(mask, params, state.params)
                opt_state = _keep_rows(mask, opt_state, state.opt_state)
            if event is not None:
                params, opt_state = self._apply_event(
                    params, opt_state, event, mask=mask if masked else None)
            metrics = {k: v.mean() for k, v in metrics.items()}
            return HSGDState(params, opt_state, state.step + 1), metrics

        return step

    def _build_round(self, rnd: Round):
        """'``n_local`` local steps then sync' as one call: the same
        per-step operations as ``n_local`` calls of the step body, so the
        trajectory is bitwise that of :meth:`HSGD.step`."""
        vupdate = torch.func.vmap(self.plan.local_update_fn())

        def round_fn(state: HSGDState, batches):
            """batches: a length-``n_local`` tuple of per-step batches."""
            params, opt_state = state.params, state.opt_state
            per_step = []
            for batch in batches:
                params, opt_state, metrics = vupdate(params, opt_state, batch)
                per_step.append({k: v.mean() for k, v in metrics.items()})
            if rnd.event is not None:
                params, opt_state = self._apply_event(params, opt_state,
                                                      rnd.event)
            # metrics stacked (n_local,) per entry
            metrics = {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}
            return HSGDState(params, opt_state,
                             state.step + rnd.n_local), metrics

        return round_fn


EXECUTORS = {"sim": SimExecutor}

ExecutorLike = Union[str, Executor, None]


def make_executor(spec: ExecutorLike = None) -> Executor:
    """Resolve an executor from an instance, a registry name, or None
    (-> SimExecutor)."""
    if isinstance(spec, Executor):
        return spec
    if spec is None:
        return SimExecutor()
    name = spec.lower()
    if name == "mesh":
        raise NotImplementedError(
            "the mesh executor is not ported yet (ROADMAP A8); use the sim "
            "executor (executor=None or 'sim')")
    if name not in EXECUTORS:
        raise KeyError(f"unknown executor {spec!r}; "
                       f"known: {sorted(EXECUTORS)}")
    return EXECUTORS[name]()
