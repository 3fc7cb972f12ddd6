"""The H-SGD engine (paper Algorithm 1 and multi-level Algorithm D.1),
PyTorch counterpart of ``repro.core.hsgd``.

* plan layer (this module) — schedule compilation (``compile_schedule``
  folds the event schedule into ``Round``s), gradient accumulation,
  history/eval bookkeeping and the typed-event dispatch;
* executor layer (:mod:`repro_torch.core.executors`) — how a round body
  runs: ``SimExecutor`` maps the per-worker update over a leading worker
  axis with ``torch.func.vmap`` and aggregates with in-array means;
  ``MeshExecutor`` runs one worker per process and aggregates with
  ``torch.distributed`` collectives.

State layout: every worker owns a full model replica; ``params``,
``opt_state`` and the comms residuals carry a leading worker axis of size n
(of 1 under the mesh executor: each process holds its own worker's row).
``HSGDState.step`` is a Python int (PyTorch runs eagerly, so reading it
costs no device sync).

Ported here: the barrier engine with comms and error feedback, on the sim
and mesh executors.  Subsystems of the JAX engine that are not ported raise
``NotImplementedError`` naming the ROADMAP item that will port them:
``runtime``, ``metrics``, ``population`` and ``async_levels`` (A7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.topology import SyncEvent, Topology
from repro_torch.device import DeviceLike, recip_f32, resolve_device
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Typed engine configuration, field for field the JAX package's
    (less ``jit``, which has no eager counterpart).  Subsystem fields take
    whatever their ``make_*`` factory accepts; the unported ones must stay
    None."""
    executor: Any = None
    comms: Any = None
    runtime: Any = None
    metrics: Any = None
    population: Any = None
    aggregate_opt_state: bool = True
    accum_steps: int = 1
    async_levels: Any = None


# EngineConfig fields whose subsystems are not ported yet -> ROADMAP item
_NOT_PORTED = {"runtime": "A7", "metrics": "A7", "population": "A7",
               "async_levels": "A7"}


@dataclasses.dataclass
class HSGDState:
    """Engine state.  The JAX package's ``metrics`` and ``pending`` fields
    belong to subsystems not ported yet."""
    params: Any      # leading worker axis n
    opt_state: Any   # leading worker axis n
    step: int        # steps taken
    comms: Any = None  # error-feedback residuals (stateful codecs), axis n


@dataclasses.dataclass(frozen=True)
class Round:
    """``n_local`` local updates, the last one followed by ``event`` (None
    for a round that ends between syncs — a schedule tail, or a cut forced
    by ``cut_every``)."""
    n_local: int
    event: Optional[SyncEvent]


def compile_schedule(schedule, cut_every: int = 0,
                     t0: int = 0) -> Tuple[Round, ...]:
    """Fold a per-step event schedule into maximal pure-local rounds.
    ``cut_every`` additionally ends a round at every absolute step that is
    a multiple of it (``t0`` = absolute step of ``schedule[0]``)."""
    rounds: List[Round] = []
    k = 0
    for i, ev in enumerate(schedule):
        k += 1
        if ev is not None or (cut_every and (t0 + i + 1) % cut_every == 0):
            rounds.append(Round(k, ev))
            k = 0
    if k:
        rounds.append(Round(k, None))
    return tuple(rounds)


def _replicate(tree, n: int):
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape))
                    .clone(), tree)


class HSGD:
    """The plan layer.  loss_fn(params, batch) -> (loss, metrics-dict).
    Batches carry a leading worker axis of size n; they may be numpy arrays
    or tensors, and are moved to the state's device."""

    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 topology: Topology, config: Optional[EngineConfig] = None):
        config = EngineConfig() if config is None else config
        for field, item in _NOT_PORTED.items():
            if getattr(config, field):
                raise NotImplementedError(
                    f"EngineConfig.{field} is not ported yet (ROADMAP "
                    f"{item}); leave it None")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.topology = topology
        self.config = config
        self.aggregate_opt_state = config.aggregate_opt_state
        self.accum_steps = config.accum_steps
        # local imports: executors imports this module for HSGDState/Round
        from repro_torch.comms.sync import make_comms
        self.comms = make_comms(config.comms)
        from repro_torch.core.executors import make_executor
        self.executor = make_executor(config.executor)
        self.executor.bind(self)

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator, model_init: Callable, *,
             device: DeviceLike = "cuda") -> HSGDState:
        """All workers start from the SAME w̄^0 (paper input):
        ``model_init(generator, device=device)``."""
        dev = resolve_device(device)
        return self.init_from_params(model_init(generator, device=dev),
                                     device=dev)

    def init_from_params(self, params, *,
                         device: DeviceLike = "cuda") -> HSGDState:
        """Start every worker from the given params (a tree of tensors,
        e.g. :func:`repro_torch.models.simple.params_from_numpy`); the
        executor then places the state (the mesh keeps this rank's row)."""
        dev = resolve_device(device)
        params0 = tree_map(lambda x: torch.as_tensor(x).to(dev), params)
        n = self.topology.n
        params = _replicate(params0, n)
        cstate = self.comms.init_state(params) if self.comms else None
        return self.executor.place(HSGDState(
            params, _replicate(self.optimizer.init(params0), n), 0, cstate))

    # -- building blocks ------------------------------------------------------
    def local_update_fn(self):
        """(params, opt_state, batch) -> (params, opt_state, metrics) for ONE
        worker, gradient accumulation folded in; executors map it over the
        worker axis with ``torch.func.vmap``."""
        grad_fn = torch.func.grad(lambda p, b: self.loss_fn(p, b),
                                  has_aux=True)
        accum = self.accum_steps

        def mean_grads(params, batch):
            if accum == 1:
                return grad_fn(params, batch)
            mbs = tree_map(lambda x: x.reshape(
                (accum, x.shape[0] // accum) + tuple(x.shape[1:])), batch)
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            ms = []
            for i in range(accum):
                g, m = grad_fn(params, tree_map(lambda x: x[i], mbs))
                gsum = tree_map(lambda a, gi: a + gi.to(torch.float32),
                                gsum, g)
                ms.append(m)
            # division rule: g / accum as XLA runs it, g * f32(1/accum)
            inv = recip_f32(accum)
            grads = tree_map(lambda g, p: (g * inv).to(p.dtype), gsum, params)
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in ms[0]}
            return grads, metrics

        def local_update(params, opt_state, batch):
            grads, metrics = mean_grads(params, batch)
            updates, opt_state = self.optimizer.update(grads, opt_state,
                                                       params)
            params = tree_map(torch.add, params, updates)
            return params, opt_state, metrics

        return local_update

    # -- executor delegation ---------------------------------------------------
    def step_fn(self, event: Optional[SyncEvent], masked: bool = False):
        return self.executor.step_fn(event, masked)

    def round_fn(self, rnd: Round):
        return self.executor.round_fn(rnd)

    def _on_device(self, batch, state: HSGDState):
        """The (n, ...) batch's rows that this process's workers take (all
        under sim, its own under the mesh), on the state's device."""
        dev = tree_leaves(state.params)[0].device
        return tree_map(lambda v: torch.as_tensor(v).to(dev),
                        self.executor.local_rows(batch))

    def step(self, state: HSGDState, batch,
             mask=None) -> Tuple[HSGDState, Dict]:
        """One step.  mask: optional (n,) bool — partial worker
        participation (Algorithm 1: a masked-out worker's update is
        discarded and it still receives the aggregate)."""
        event = self.topology.event_at(state.step)
        batch = self._on_device(batch, state)
        if mask is None:
            return self.step_fn(event)(state, batch)
        dev = tree_leaves(state.params)[0].device
        mask = torch.as_tensor(mask).to(dev).to(torch.bool)
        return self.step_fn(event, masked=True)(state, batch, mask)

    # -- schedule-compiled round executor --------------------------------------
    def run_rounds(self, state: HSGDState, batch_fn: Callable[[int], Any],
                   T: int, *, eval_every: int = 0,
                   eval_fn: Optional[Callable[[HSGDState, int], Dict]] = None
                   ) -> Tuple[HSGDState, List[Dict]]:
        """Run T steps through the schedule-compiled executor: the schedule
        is folded into rounds (``compile_schedule``) and each runs as one
        call on the bound executor.  The trajectory is bitwise that of T
        calls of :meth:`step` (tested).

        History records per-step training metrics for every step; with
        ``eval_every`` the schedule is also cut every ``eval_every`` steps
        so ``eval_fn(state, t)`` fires exactly there (and at the end).  With
        comms on, every record carries ``wire_bytes`` — the bytes that
        step's sync moved (0 between syncs), computed statically."""
        t0 = state.step
        cut = eval_every if (eval_fn is not None and eval_every) else 0
        schedule = self.topology.schedule(t0 + T)[t0:]
        rounds = compile_schedule(schedule, cut_every=cut, t0=t0)
        wire = None
        if self.comms is not None:
            ws = self.wire_stats(state)
            wire = [ws.bytes_for_event(ev) for ev in schedule]
        raw: List[Tuple[int, int, Dict]] = []  # (t_end, n_local, metrics)
        evals: Dict[int, Dict] = {}
        t = t0
        for rnd in rounds:
            batches = tuple(self._on_device(batch_fn(t + i), state)
                            for i in range(rnd.n_local))
            state, metrics = self.round_fn(rnd)(state, batches)
            t += rnd.n_local
            raw.append((t, rnd.n_local, metrics))
            if eval_fn is not None and eval_every and \
                    (t % eval_every == 0 or t == t0 + T):
                evals[t] = eval_fn(state, t - 1)
        # metrics stay on the device until here, one transfer per round
        history: List[Dict] = []
        for t_end, n_local, metrics in raw:
            vals = {k: v.tolist() for k, v in metrics.items()}
            for i in range(n_local):
                step_no = t_end - n_local + i + 1
                rec = {"t": step_no,
                       **{k: float(v[i]) for k, v in vals.items()}}
                if wire is not None:
                    rec["wire_bytes"] = wire[step_no - t0 - 1]
                rec.update(evals.get(step_no, {}))
                history.append(rec)
        return state, history

    # -- inspection ------------------------------------------------------------
    def wire_stats(self, state: HSGDState):
        """Static per-level wire accounting for this engine's sync payloads
        (:class:`repro_torch.comms.wire.WireStats`), or None with comms
        off: params, plus the optimizer moments when
        ``aggregate_opt_state`` puts them on the wire."""
        if self.comms is None:
            return None
        from repro_torch.comms.wire import WireArray, WireStats
        parts = [("params", state.params)]
        if self.aggregate_opt_state:
            moments = _moments_only(state.opt_state)
            if tree_leaves(moments):
                parts.append(("moments", moments))
        payload: List[Any] = []
        n_elements = 0
        for name, tree in parts:
            arrays, n = self.comms.payload_spec(tree)
            payload += [WireArray(f"{name}.{a.name}", a.shape, a.dtype)
                        for a in arrays]
            n_elements += n
        return WireStats(self.topology, tuple(payload), n_elements)

    def mean_params(self, state: HSGDState):
        """w̄^t (the analysis object; observable only at t = aG).  Under the
        mesh executor every rank gathers all workers' rows first, so this
        is the sim's arithmetic on every rank."""
        return tree_map(lambda x: x.mean(0, dtype=torch.float32).to(x.dtype),
                        self.executor.gather(state.params))


def _moments_only(opt_state):
    """The optimizer moments a sync aggregates; ``step`` never rides it."""
    return {k: v for k, v in opt_state.items() if k in ("m", "v")}


def _merge_moments(opt_state, agg):
    out = dict(opt_state)
    out.update(agg)
    return out
