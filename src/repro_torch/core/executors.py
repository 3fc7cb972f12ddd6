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
aggregate, and its unconsumed error-feedback residual is kept).
"""
from __future__ import annotations

import abc
import math
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.comms.reduce import ExactWireOps, MeshWireOps, SimWireOps
from repro_torch.core.aggregators import Aggregator, flat_worker_index
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
        self._validate()
        return self

    def _validate(self) -> None:
        """Check that the bound plan runs on this backend (fail fast)."""

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

    def round_fn(self, rnd: Round):
        if rnd not in self._round_fns:
            self._round_fns[rnd] = self._build_round(rnd)
        return self._round_fns[rnd]

    # -- the backend's hooks ----------------------------------------------
    @abc.abstractmethod
    def _apply_event(self, params, opt_state, cstate, event: SyncEvent,
                     mask=None):
        """One sync of this process's rows: (params, opt_state, cstate)."""

    def _own_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """The entries of an (n,) mask for this process's rows."""
        return mask

    def _vupdate(self):
        """The per-worker local update mapped over this process's rows."""
        return torch.func.vmap(self.plan.local_update_fn())

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

        def step(state: HSGDState, batch, mask=None):
            params, opt_state, metrics = vupdate(state.params,
                                                 state.opt_state, batch)
            if masked:
                # non-participating workers keep their previous state
                keep = self._own_mask(mask)
                params = _keep_rows(keep, params, state.params)
                opt_state = _keep_rows(keep, opt_state, state.opt_state)
            cstate = state.comms
            if event is not None:
                params, opt_state, cstate = self._apply_event(
                    params, opt_state, cstate, event,
                    mask=mask if masked else None)
            metrics = {k: v[0] for k, v in
                       self._metric_means([metrics]).items()}
            return HSGDState(params, opt_state, state.step + 1,
                             cstate), metrics

        return step

    def _build_round(self, rnd: Round):
        """'``n_local`` local steps then sync' as one call: the same
        per-step operations as ``n_local`` calls of the step body, so the
        trajectory is bitwise that of :meth:`HSGD.step`."""
        vupdate = self._vupdate()

        def round_fn(state: HSGDState, batches):
            """batches: a length-``n_local`` tuple of per-step batches."""
            params, opt_state = state.params, state.opt_state
            per_step = []
            for batch in batches:
                params, opt_state, metrics = vupdate(params, opt_state, batch)
                per_step.append(metrics)
            cstate = state.comms
            if rnd.event is not None:
                params, opt_state, cstate = self._apply_event(
                    params, opt_state, cstate, rnd.event)
            return HSGDState(params, opt_state, state.step + rnd.n_local,
                             cstate), self._metric_means(per_step)

        return round_fn


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


class SimExecutor(Executor):
    """n workers on one device; aggregations are reshape means (uniform
    hierarchy) or membership segment means (arbitrary groupings) through
    ``topology.aggregate``, or the codec's wire path with comms on.

    ``step_fn(event, masked=True)`` is Algorithm-1 partial participation: a
    masked-out worker's update is discarded and it still receives the
    aggregate."""

    def _apply_event(self, params, opt_state, cstate, event: SyncEvent,
                     mask=None):
        plan = self.plan
        reduce_fn = lambda tree: plan.topology.aggregate(tree, event,
                                                         mask=mask)
        wire = SimWireOps(plan.topology.spec.group_sizes, event.level,
                          mask) if _wire_eligible(plan, event) else None
        new_p, new_o, new_c = _apply_sync(plan, reduce_fn, params, opt_state,
                                          cstate, wire=wire)
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
    be initialized with one process per worker (``launch.mesh.launch``).

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

    ``step_fn(event, masked=True)`` is Algorithm 1, as on sim; the elastic
    drop rounds (runtime) and the stale fold (async) are ROADMAP A7."""

    def __init__(self, mesh=None, *, exact: bool = False):
        super().__init__()
        self.mesh = mesh
        self.exact = bool(exact)

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
        if world != topo.n:
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

    # -- layout ---------------------------------------------------------------
    def _row(self, tree):
        r = self.widx
        return tree_map(lambda x: x[r:r + 1].clone(), tree)

    def place(self, state: HSGDState) -> HSGDState:
        """Keep this rank's row of a freshly initialized (n, ...) state."""
        return HSGDState(self._row(state.params), self._row(state.opt_state),
                         state.step, None if state.comms is None
                         else self._row(state.comms))

    def local_rows(self, batch):
        r = self.widx
        return tree_map(lambda x: x[r:r + 1], batch)

    def gather(self, tree):
        world = self.mesh.world
        return tree_map(world.all_gather, tree)

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
                     mask=None):
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
            w = topo._event_weights(event, mask,
                                    tree_leaves(params)[0].device)
            w = None if w is None else w[widx]
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
