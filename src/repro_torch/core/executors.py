"""The executor layer: HOW a compiled H-SGD round runs (PyTorch counterpart
of ``repro.core.executors``).

* :class:`SimExecutor` — the reproduction backend.  One device; ``params``
  carry a leading worker axis, the per-worker update is mapped over it with
  ``torch.func.vmap`` (the counterpart of ``jax.vmap(local_update)``), and
  syncs are in-array means via ``topology.aggregate`` — or, with a comms
  plan, go through the codec's wire path.
* :class:`MeshExecutor` — the deployment backend: one worker per process
  of a ``torch.distributed`` world (``launch.mesh.launch``), each holding
  its own row (a worker axis of 1, the per-shard view of the reference's
  ``shard_map``), and each sync a collective over the process group of the
  event's levels (``launch.mesh.make_hsgd_mesh``).  ``exact=True`` replays
  the sim reduce on the gathered worker block instead, bit for bit the sim
  trajectory.

Both keep the same masked-step contract (Algorithm 1: a masked-out worker's
update is discarded, it contributes nothing and still receives the
aggregate, and its unconsumed error-feedback residual is kept), and both
run the elastic-drop rounds of a runtime (``round_fn(rnd, masked=True)``:
a dropped worker ran its local updates but neither contributes to nor
receives the aggregate), the stale folds of async execution
(``Round.stale``), the in-round divergence probe of a metrics plan (a row
of the pre-aggregation params at every sync) and the population regime's
inner rounds.
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.comms.reduce import ExactWireOps, MeshWireOps, SimWireOps
from repro_torch.core.aggregators import Aggregator, flat_worker_index
from repro_torch.core.hsgd import (HSGDState, Round, StaleSlot, StaleSnap,
                                   _merge_moments, _moments_only)
from repro_torch.core.topology import SyncEvent
from repro_torch.tree import tree_leaves, tree_map


class Executor(abc.ABC):
    """Backend contract: build (and cache) the step/round bodies for one
    bound plan-layer engine."""

    def __init__(self):
        self.plan = None
        self._step_fns: Dict[Any, Any] = {}
        self._round_fns: Dict[Any, Any] = {}
        # builds of each round body: R4's counterpart of a jit cache size
        self._round_builds: Dict[Any, int] = {}

    def bind(self, plan) -> "Executor":
        """Attach to an :class:`~repro_torch.core.hsgd.HSGD` plan.  One
        executor serves one engine."""
        assert self.plan is None or self.plan is plan, \
            "executor is already bound to another engine"
        self.plan = plan
        self._validate()
        return self

    def _validate(self) -> None:
        """Check that the bound plan runs on this backend (fail fast)."""

    def twin(self) -> "Executor":
        """A fresh UNBOUND executor with this one's settings, for derived
        engines (the population engine's inner engine): one executor
        instance serves one engine."""
        return type(self)()

    def place(self, state: HSGDState) -> HSGDState:
        """Lay a freshly initialized (n, ...) state out for this backend."""
        return state

    def local_rows(self, batch):
        """The rows of an (n, ...) batch that this process's workers take."""
        return batch

    def gather(self, tree):
        """The (n, ...) tree of every worker's rows, from this process."""
        return tree

    def step_fn(self, event: Optional[SyncEvent], masked: bool = False):
        key = (event, masked)
        if key not in self._step_fns:
            self._step_fns[key] = self._build_step(event, masked)
        return self._step_fns[key]

    def round_fn(self, rnd: Round, masked: bool = False):
        key = (rnd, masked)
        if key not in self._round_fns:
            self._round_fns[key] = self._build_round(rnd, masked)
            self._round_builds[key] = self._round_builds.get(key, 0) + 1
        return self._round_fns[key]

    def round_builds(self, rnd: Round, masked: bool = False) -> int:
        """How many times the body of this Round signature was built (rule
        R4: once, however many rounds ``run_rounds`` dispatched)."""
        return self._round_builds.get((rnd, masked), 0)

    # -- the analysis layer's surface (repro_torch.analysis) -----------------
    def sync_fn(self, event: SyncEvent):
        """The aggregation subprogram one sync event runs in every round
        body: ``(params, opt_state, cstate, mask=None) -> (params,
        opt_state, cstate)``, the same :meth:`_apply_event` the round
        calls, exposed alone so that the analysis layer can record WHAT an
        event ships without the local updates around it."""
        def sync(params, opt_state, cstate, mask=None):
            return self._apply_event(params, opt_state, cstate, event,
                                     mask=mask)
        return sync

    def sync_program(self, event: SyncEvent, state: HSGDState, mask=None):
        """The recorder's summary of one :meth:`sync_fn` call on a copy of
        ``state``'s params, opt state and residuals (rules R1/R2/R5)."""
        from repro_torch.analysis.walker import trace
        return trace(self.sync_fn(event), state.params, state.opt_state,
                     state.comms, mask=mask)

    def round_program(self, rnd: Round, state: HSGDState, batches,
                      mask=None):
        """The recorder's summary of one call of the cached round body
        ``run_rounds`` dispatches for this Round, on a copy of ``state``
        and of the batches moved to the state's device (rules R3/R4 and
        the per-round collective count).  One unrecorded call runs first:
        what a body builds once and caches (the probes' grouping
        constants) is its warm-up, as compilation is the reference's."""
        import copy
        from repro_torch.analysis.walker import trace
        fn = self.round_fn(rnd, masked=mask is not None)
        batches = tuple(self.plan._on_device(b, state) for b in batches)
        args = (state, batches) if mask is None else (state, batches, mask)
        fn(*copy.deepcopy(args))
        return trace(fn, *args)

    # -- the backend's hooks ----------------------------------------------
    @abc.abstractmethod
    def _apply_event(self, params, opt_state, cstate, event: SyncEvent,
                     mask=None, drop: bool = False):
        """One sync of this process's rows: (params, opt_state, cstate).
        ``drop`` is the elastic-drop semantics of a masked round."""

    def _own_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """The entries of an (n,) mask for this process's rows."""
        return mask

    def _vupdate(self):
        """The per-worker local update mapped over this process's rows."""
        return torch.func.vmap(self.plan.local_update_fn())

    def _probe_row_fn(self, event: Optional[SyncEvent]):
        """The divergence probe for sync steps (None when metrics are off,
        divergences disabled, or there is no event).  Taken BEFORE the
        sync so it measures the PRE-aggregation worker params — the live
        eq. (10) partition."""
        plan = self.plan
        if event is None or plan.metrics is None \
                or not plan.metrics.divergences:
            return None
        return plan.metrics.sim_row_fn(plan.topology)

    def _metric_means(self, per_step) -> Dict[str, torch.Tensor]:
        """The per-step metrics of a round, each meaned over the worker
        axis: {key: (n_local,)}."""
        return {k: torch.stack([m[k].mean() for m in per_step])
                for k in per_step[0]}

    # -- the bodies ---------------------------------------------------------
    def _build_step(self, event: Optional[SyncEvent], masked: bool = False):
        """One step; ``masked`` is Algorithm-1 partial participation: a
        masked-out worker's update is discarded, it contributes nothing and
        still receives the aggregate."""
        vupdate = self._vupdate()
        row_fn = self._probe_row_fn(event)
        # the staleness channel widens the probe row; the per-step path has
        # no stale boundaries (plan.step refuses async engines), so it pads 0
        stale_channel = row_fn is not None and self.plan.metrics.staleness

        def step(state: HSGDState, batch, mask=None):
            params, opt_state, metrics = vupdate(state.params,
                                                 state.opt_state, batch)
            if masked:
                # non-participating workers keep their previous state
                keep = self._own_mask(mask)
                params = _keep_rows(keep, params, state.params)
                opt_state = _keep_rows(keep, opt_state, state.opt_state)
            cstate, mbuf = state.comms, state.metrics
            if event is not None:
                if row_fn is not None and mbuf is not None:
                    row = row_fn(params)
                    if stale_channel:
                        row = torch.cat([row, row.new_zeros(1)])
                    mbuf = mbuf.push(row)
                params, opt_state, cstate = self._apply_event(
                    params, opt_state, cstate, event,
                    mask=mask if masked else None)
            metrics = {k: v[0] for k, v in
                       self._metric_means([metrics]).items()}
            return HSGDState(params, opt_state, state.step + 1, cstate,
                             mbuf, state.pending), metrics

        return step

    def _build_round(self, rnd: Round, masked: bool = False):
        """'``n_local`` local steps then sync' as one call: the same
        per-step operations as ``n_local`` calls of the step body, so the
        trajectory is bitwise that of :meth:`HSGD.step`.

        ``masked=True`` builds the elastic-drop variant ``(state, batches,
        mask)``: every worker runs the local block (a dropped worker was
        computing, not absent), and the round's sync runs with drop
        semantics (see :meth:`SimExecutor._apply_event`).  A round with
        stale ops folds what is due and snapshots (:meth:`_stale_fold`); a
        flush boundary's fresh sync applies after its folds, and a drop
        restores the pre-boundary state once, so that a dropped worker
        misses the folds, the snapshot roll and the fresh aggregate alike.
        With a metrics plan, the probe row of the pre-aggregation (and
        pre-fold) params is pushed at the sync, widened by the staleness
        channel under async levels."""
        vupdate = self._vupdate()
        row_fn = self._probe_row_fn(rnd.event)
        stale_channel = row_fn is not None and self.plan.metrics.staleness
        if masked:
            assert rnd.event is not None, \
                "a masked round needs a sync event to drop workers from"

        def round_fn(state: HSGDState, batches, mask=None):
            """batches: a length-``n_local`` tuple of per-step batches;
            mask: the (n,) bool tensor of a masked round."""
            params, opt_state = state.params, state.opt_state
            per_step = []
            for batch in batches:
                params, opt_state, metrics = vupdate(params, opt_state, batch)
                per_step.append(metrics)
            cstate, mbuf, pending = state.comms, state.metrics, state.pending
            if rnd.event is not None:
                div_row = row_fn(params) \
                    if (row_fn is not None and mbuf is not None) else None
                stale_val = None
                if rnd.stale:
                    p0, o0, c0, pend0 = params, opt_state, cstate, pending
                    params, opt_state, pending, stale_val = self._stale_fold(
                        params, opt_state, pending, rnd.stale, mask,
                        rnd.event, want_staleness=stale_channel)
                    if not rnd.stale[-1].snapshot:
                        params, opt_state, cstate = self._apply_event(
                            params, opt_state, cstate, rnd.event, mask=mask)
                    if masked:
                        keep = self._own_mask(mask)
                        params = _keep_rows(keep, params, p0)
                        opt_state = _keep_rows(keep, opt_state, o0)
                        if cstate is not None:
                            cstate = _keep_rows(keep, cstate, c0)
                        pending = _pending_map(
                            lambda a, b: _keep_rows(keep, a, b), pending,
                            pend0)
                else:
                    params, opt_state, cstate = self._apply_event(
                        params, opt_state, cstate, rnd.event, mask=mask,
                        drop=masked)
                if div_row is not None:
                    if stale_channel:
                        if stale_val is None:
                            stale_val = div_row.new_zeros(())
                        div_row = torch.cat([div_row, stale_val[None]])
                    mbuf = mbuf.push(div_row)
            return HSGDState(params, opt_state, state.step + rnd.n_local,
                             cstate, mbuf, pending), \
                self._metric_means(per_step)

        return round_fn

    def _stale_fold(self, params, opt_state, pending, ops, mask,
                    event: SyncEvent, want_staleness: bool = False):
        """Apply one boundary's static :class:`~repro_torch.core.hsgd.
        StaleOp`s: each fold applies a stored snapshot's POSTED aggregate
        to the live state as an elementwise delta (:func:`_stale_delta`);
        a ``snapshot`` op then runs the level's aggregation on the
        post-fold payload, through the same :meth:`_apply_event` a fresh
        sync takes (codecs, wire eligibility and masked-residual keeping
        included, against the SLOT's own residual chain), and captures
        payload and aggregate into the newest slot.  Aggregating at
        posting time pins each outstanding sync to the participation mask
        of the boundary that posted it.

        Returns ``(params, opt_state, pending, staleness)``: ``staleness``
        (only when requested, else None) is the probe scalar, the
        worker-mean ‖applied − fresh‖² against the codec-free barrier
        aggregate of the pre-fold params, 0 at warm-up and flush
        boundaries."""
        plan = self.plan
        agg_opt = plan.aggregate_opt_state
        pre_params = params
        pending = dict(pending)
        for op in ops:
            slot = pending[op.level]
            snaps, res = list(slot.snaps), slot.residual
            s = len(snaps)
            for j in range(op.n_fold):
                snap = snaps[s - op.warm + j]
                params = _stale_delta(params, snap.agg, snap.params)
                if agg_opt:
                    opt_state = _merge_moments(opt_state, _stale_delta(
                        _moments_only(opt_state), snap.agg_opt, snap.opt))
            if op.snapshot:
                base_o = _moments_only(opt_state) if agg_opt else {}
                new_p, new_o, res = self._apply_event(
                    params, base_o, res, SyncEvent(level=op.level),
                    mask=mask)
                snaps = snaps[1:] + [StaleSnap(
                    params, base_o, new_p,
                    _moments_only(new_o) if agg_opt else {})]
            pending[op.level] = StaleSlot(tuple(snaps), res)
        stale_val = None
        if want_staleness:
            own = ops[-1] if ops and ops[-1].snapshot else None
            if own is not None and own.n_fold:
                stale_val = self._staleness(pre_params, params, event, mask)
            else:
                stale_val = tree_leaves(params)[0].new_zeros(
                    (), dtype=torch.float32)
        return params, opt_state, pending, stale_val

    def _staleness(self, pre_params, params, event: SyncEvent, mask):
        """The staleness probe scalar: the worker-mean ‖params − fresh‖²,
        ``fresh`` the codec-free barrier aggregate of the pre-fold params.
        Here the sim's: ``topology.aggregate`` on the worker block."""
        fresh = self.plan.topology.aggregate(pre_params, event, mask=mask)
        d2 = sum((a - f).to(torch.float32).square()
                 .reshape(a.shape[0], -1).sum(1)
                 for a, f in zip(tree_leaves(params), tree_leaves(fresh)))
        return d2.mean()


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


def _apply_sync(plan, reduce_fn, params, opt_state, cstate, wire=None):
    """Apply ``reduce_fn`` (the backend's means) either directly or through
    the comms wire; optimizer moments ride the same path (without error
    feedback), and the optimizer's ``step`` never does.  ``cstate`` is the
    error-feedback residual tree or None; ``wire`` is the WireOps when the
    event runs as a compressed collective, else None."""
    if plan.comms is None:
        sync = reduce_fn
    else:
        def sync(tree):
            return plan.comms.sync(tree, reduce_fn, reduce_mode=wire)
    if cstate is None:
        params = sync(params)
    else:
        params, cstate = plan.comms.sync(params, reduce_fn,
                                         reduce_mode=wire, residual=cstate)
    moments = _moments_only(opt_state) if plan.aggregate_opt_state else {}
    if tree_leaves(moments):
        opt_state = _merge_moments(opt_state, sync(moments))
    return params, opt_state, cstate


def _keep_rows(mask: torch.Tensor, new, old):
    """Row-select on the leading worker axis: mask True -> ``new``, False ->
    ``old``."""
    def sel(a, b):
        return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
    return tree_map(sel, new, old)


def _pending_map(fn, pending, *rest):
    """``fn`` over the tensor trees of pending stale slots ({level:
    StaleSlot}), field by field: the tree helpers walk dicts only, and a
    slot's residual is None without a stateful codec.  ``rest`` are slot
    dicts of the same layout, passed to ``fn`` beside."""
    def slot(a: StaleSlot, *others: StaleSlot) -> StaleSlot:
        snaps = tuple(
            StaleSnap(*(fn(getattr(x, f.name),
                           *(getattr(y, f.name) for y in ys))
                        for f in dataclasses.fields(StaleSnap)))
            for x, *ys in zip(a.snaps, *(o.snaps for o in others)))
        res = None if a.residual is None else \
            fn(a.residual, *(o.residual for o in others))
        return StaleSlot(snaps, res)
    return {lvl: slot(pending[lvl], *(r[lvl] for r in rest))
            for lvl in pending}


def _is_pending(tree) -> bool:
    return isinstance(tree, dict) and bool(tree) and all(
        isinstance(v, StaleSlot) for v in tree.values())


def _stale_delta(live, agg, snap):
    """The stale-sync fold: the aggregate was computed on ``snap`` and the
    live state has moved on since, so the aggregation applies as a
    correction, ``live + (agg - snap)``, elementwise per worker row."""
    return tree_map(lambda a, b, c: a + (b - c), live, agg, snap)


class SimExecutor(Executor):
    """n workers on one device; aggregations are reshape means (uniform
    hierarchy) or membership segment means (arbitrary groupings) through
    ``topology.aggregate``, or the codec's wire path with comms on.

    ``step_fn(event, masked=True)`` is Algorithm-1 partial participation: a
    masked-out worker's update is discarded and it still receives the
    aggregate.  ``round_fn(rnd, masked=True)`` is the elastic-drop
    semantics: a dropped worker ran its local updates but neither
    contributes to nor receives the aggregate, keeping its exact
    post-update params, opt state, unconsumed residuals and stale slots."""

    def _apply_event(self, params, opt_state, cstate, event: SyncEvent,
                     mask=None, drop: bool = False):
        """``mask`` weights the aggregation over participating workers.
        ``drop=False``: masked-out workers still RECEIVE the aggregate
        (Algorithm 1).  ``drop=True``: they neither contribute nor receive
        — they keep their post-update params, opt state and unconsumed
        residuals."""
        plan = self.plan
        reduce_fn = lambda tree: plan.topology.aggregate(tree, event,
                                                         mask=mask)
        wire = SimWireOps(plan.topology.spec.group_sizes, event.level,
                          mask) if _wire_eligible(plan, event) else None
        new_p, new_o, new_c = _apply_sync(plan, reduce_fn, params, opt_state,
                                          cstate, wire=wire)
        if drop:
            new_p = _keep_rows(mask, new_p, params)
            new_o = _keep_rows(mask, new_o, opt_state)
            if cstate is not None:
                new_c = _keep_rows(mask, new_c, cstate)
        if plan.comms is not None:
            # topology.aggregate keeps non-participants' rows untouched, but
            # the comms path hands it codec-roundtripped payloads — restore
            # the true state (and unconsumed residual) of workers a
            # partial-group event did not sync
            part = plan.topology.participants(event)
            if part is not None:
                keep = torch.as_tensor(
                    part, device=tree_leaves(params)[0].device)
                new_p = _keep_rows(keep, new_p, params)
                new_o = _keep_rows(keep, new_o, opt_state)
                if cstate is not None:
                    new_c = _keep_rows(keep, new_c, cstate)
            if mask is not None and cstate is not None:
                # runtime-masked workers receive the aggregate but sent
                # nothing: their error-feedback residual is not consumed
                new_c = _keep_rows(mask, new_c, cstate)
        return new_p, new_o, new_c


class MeshExecutor(Executor):
    """One worker per process; sync events are collectives over the
    process group of the event's levels.

    mesh: an :class:`~repro_torch.launch.mesh.HSGDMesh` whose axes mirror
    the hierarchy's ``group_sizes`` (``make_hsgd_mesh(spec.group_sizes)``);
    a ``GroupedTopology`` lowers over all ranks, so any mesh of ``n`` ranks
    serves it.  None builds the matching mesh at bind time, which every
    rank must then do in the same order.  The default process group must
    be initialized with one process per worker (``launch.mesh.launch``),
    or with ``mesh.model`` processes per worker for a mesh built over a
    ``DeviceMesh`` whose trailing dims hold a worker's ranks (the dry
    run's tensor parallelism inside a worker, ``launch.dryrun``).

    Each process holds its own worker's row of params, optimizer state and
    residuals (a leading worker axis of 1) and takes its own row of every
    batch, so the program each rank runs is the sim program: the same
    ``vmap``'d local update, over 1 row instead of n.  ``gather`` brings the
    (n, ...) rows back on every rank (``HSGD.mean_params`` uses it).

    exact: replay the whole sim reduce on every rank — all-gather the
    worker block, run ``topology.aggregate`` (or ``ExactWireOps``) on it
    and keep this rank's row — instead of the production collectives, and
    run the local update at the sim's batch shape (see :meth:`_vupdate`).
    Bit for bit the sim trajectory, at n times the sync bytes and the
    local work (verification mode); the production lowering matches sim
    to accumulation rounding.

    ``step_fn(event, masked=True)`` is Algorithm 1 and ``round_fn(rnd,
    masked=True)`` the elastic drop round, as on sim: each rank applies
    the drop to its own row.  The runtime clock and the population's draws
    are host numpy from their seeds, the same on every rank.  Async levels
    fold per row (the posting-time aggregation through the same sync);
    the staleness scalar is one world mean of this row's distance to the
    production aggregate of the pre-fold params, in exact mode too, so it
    matches sim to rounding.  The probe row is
    :meth:`~repro_torch.obs.Metrics.mesh_row_fn` (L+2 collectives, every
    value replicated) and the metric buffer is replicated on every rank.
    A topology without level structure (grouped) refuses divergence
    probes, as the reference does."""

    def __init__(self, mesh=None, *, exact: bool = False):
        super().__init__()
        self.mesh = mesh
        self.exact = bool(exact)

    def twin(self) -> "MeshExecutor":
        return MeshExecutor(mesh=self.mesh, exact=self.exact)

    def _validate(self) -> None:
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_hsgd_mesh
        topo = self.plan.topology
        spec = getattr(topo, "spec", None)
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "the mesh executor runs one process per worker and needs an "
                "initialized default process group: start the program with "
                "repro_torch.launch.mesh.launch(fn, n_workers), or use the "
                "sim executor (executor='sim')")
        world = dist.get_world_size()
        model = 1 if self.mesh is None else self.mesh.model
        if world != topo.n * model:
            raise ValueError(
                f"the mesh executor runs one process per worker: "
                f"{type(topo).__name__} has {topo.n} workers, the process "
                f"group {world} processes")
        if self.mesh is None:
            self.mesh = make_hsgd_mesh(
                spec.group_sizes if spec is not None else (topo.n,))
        sizes = self.mesh.group_sizes
        if spec is not None:
            if sizes != tuple(spec.group_sizes):
                raise ValueError(
                    f"mesh axes {dict(zip(self.mesh.axis_names, sizes))} do "
                    f"not mirror the hierarchy levels {spec.group_sizes}; "
                    f"build the mesh with make_hsgd_mesh(spec.group_sizes)")
        elif math.prod(sizes) != topo.n:
            raise ValueError(
                f"{type(topo).__name__} lowers over the flat worker axis: "
                f"need a mesh of {topo.n} workers, got "
                f"{dict(zip(self.mesh.axis_names, sizes))}")
        self.widx = flat_worker_index(self.mesh)
        if spec is None and self.plan.metrics is not None \
                and self.plan.metrics.divergences:
            raise NotImplementedError(
                f"{type(topo).__name__} has no named-axis level structure "
                "for the in-graph divergence probe; run it on the simulator "
                "(HSGD(..., executor='sim')) or disable divergence probing "
                "(metrics=Metrics(divergences=False))")

    # -- layout ---------------------------------------------------------------
    def _row(self, tree):
        r = self.widx
        return tree_map(lambda x: x[r:r + 1].clone(), tree)

    def place(self, state: HSGDState) -> HSGDState:
        """Keep this rank's row of a freshly initialized (n, ...) state:
        params, opt state, residuals and every pending slot's rows; the
        probe ring is replicated, so every rank keeps it whole."""
        carried = ("params", "opt_state", "step", "comms", "metrics",
                   "pending")
        assert tuple(f.name for f in dataclasses.fields(HSGDState)) == \
            carried, "MeshExecutor.place does not lay out every HSGDState " \
            "field"
        return HSGDState(
            self._row(state.params), self._row(state.opt_state), state.step,
            comms=None if state.comms is None else self._row(state.comms),
            metrics=state.metrics,
            pending=None if state.pending is None
            else _pending_map(self._row, state.pending))

    def local_rows(self, batch):
        r = self.widx
        return tree_map(lambda x: x[r:r + 1], batch)

    def gather(self, tree):
        """The (n, ...) rows of a tree, or of pending stale slots, on
        every rank."""
        if _is_pending(tree):
            return _pending_map(self.gather, tree)
        return tree_map(self.mesh.world.all_gather, tree)

    def _own_mask(self, mask):
        return mask[self.widx:self.widx + 1]

    def _vupdate(self):
        """Production: the update over this rank's one row.  Exact: over
        the row repeated n times, first copy kept, so that every op runs
        at the sim's batch shape — on the card cuBLAS picks another kernel
        for a batched product of 1 than of n, and the last bit it changes
        would grow through a codec's rounding (ROADMAP C)."""
        vupdate = super()._vupdate()
        if not self.exact:
            return vupdate
        n = self.plan.topology.n

        def rep(tree):
            return tree_map(
                lambda x: x.repeat((n,) + (1,) * (x.ndim - 1)), tree)

        def update(params, opt_state, batch):
            out = vupdate(rep(params), rep(opt_state), rep(batch))
            return tuple(tree_map(lambda x: x[:1], t) for t in out)

        return update

    def _probe_row_fn(self, event: Optional[SyncEvent]):
        plan = self.plan
        if event is None or plan.metrics is None \
                or not plan.metrics.divergences:
            return None
        return plan.metrics.mesh_row_fn(plan.topology, self.mesh)

    def _row_weight(self, event: SyncEvent, mask, device):
        """This rank's weight on a production collective: its runtime mask
        entry times the static weights (None = plain mean)."""
        w = self.plan.topology._event_weights(event, mask, device)
        return None if w is None else w[self.widx]

    def _staleness(self, pre_params, params, event: SyncEvent, mask):
        """The reference's mesh form: this row's ‖params − fresh‖², fresh
        the production aggregate of the pre-fold params, then one world
        mean (replicated)."""
        topo, mesh, widx = self.plan.topology, self.mesh, self.widx
        w = self._row_weight(event, mask, tree_leaves(params)[0].device)
        fresh = tree_map(lambda x: topo.shard_aggregate(
            x, mesh, event, worker_index=widx, weight=w), pre_params)
        d2 = sum((a - f).to(torch.float32).square().sum()
                 for a, f in zip(tree_leaves(params), tree_leaves(fresh)))
        world = mesh.world
        return world.psum(d2) / world.size

    def _metric_means(self, per_step):
        """The sim's means over the gathered rows of every worker: one
        all-gather a round, then the mean of each contiguous (n,) row."""
        keys = sorted(per_step[0])
        local = torch.stack([torch.stack([m[k].reshape(()) for k in keys])
                             for m in per_step])[None]   # (1, steps, keys)
        g = self.mesh.world.all_gather(local)              # (n, steps, keys)
        return {k: torch.stack([g[:, i, j].contiguous().mean()
                                for i in range(len(per_step))])
                for j, k in enumerate(keys)}

    # -- the sync of one event, for this rank's row ---------------------------
    def _apply_event(self, params, opt_state, cstate, event: SyncEvent,
                     mask=None, drop: bool = False):
        plan, mesh, widx = self.plan, self.mesh, self.widx
        topo = plan.topology
        wire = None
        if _wire_eligible(plan, event):
            # exact mode replays the sim wire arithmetic on the gathered
            # block; production runs the codec's collective over the
            # event's process group
            wire = ExactWireOps(mesh.world, widx, topo.spec.group_sizes,
                                event.level, mask) if self.exact else \
                MeshWireOps(mesh.axes(topo.level_axes(event,
                                                      mesh.axis_names)),
                            mask, widx)
        if self.exact:
            def reduce_fn(tree):
                out = topo.aggregate(self.gather(tree), event, mask=mask)
                return tree_map(lambda x: x[widx:widx + 1], out)
        else:
            w = self._row_weight(event, mask, tree_leaves(params)[0].device)
            reduce_fn = lambda tree: tree_map(
                lambda x: topo.shard_aggregate(
                    x, mesh, event, worker_index=widx, weight=w), tree)
        new_p, new_o, new_c = _apply_sync(plan, reduce_fn, params, opt_state,
                                          cstate, wire=wire)
        if plan.comms is not None:
            # the restores of SimExecutor._apply_event, for this row
            part = topo.participants(event)
            if part is not None and not part[widx]:
                new_p, new_o, new_c = params, opt_state, cstate
            if mask is not None and cstate is not None:
                new_c = _keep_rows(self._own_mask(mask), new_c, cstate)
        if drop:
            # elastic drop: a dropped row keeps its post-update params, opt
            # state and unconsumed residual
            keep = self._own_mask(mask)
            new_p = _keep_rows(keep, new_p, params)
            new_o = _keep_rows(keep, new_o, opt_state)
            if cstate is not None:
                new_c = _keep_rows(keep, new_c, cstate)
        return new_p, new_o, new_c


EXECUTORS = {"sim": SimExecutor, "mesh": MeshExecutor}

ExecutorLike = Union[str, Executor, None]


def make_executor(spec: ExecutorLike = None, **kwargs) -> Executor:
    """Resolve an executor from an instance, a registry name, or None
    (-> SimExecutor); ``kwargs`` construct it by name, e.g.
    ``make_executor("mesh", exact=True)``."""
    if isinstance(spec, Executor):
        if kwargs:
            raise ValueError("kwargs only apply when constructing by name")
        return spec
    if spec is None:
        return SimExecutor(**kwargs)
    name = spec.lower()
    if name not in EXECUTORS:
        raise KeyError(f"unknown executor {spec!r}; "
                       f"known: {sorted(EXECUTORS)}")
    return EXECUTORS[name](**kwargs)


def register_executor(name: str, cls) -> None:
    EXECUTORS[name.lower()] = cls
