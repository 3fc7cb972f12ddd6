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

Ported here, on the sim and mesh executors alike: the barrier engine with
comms and error feedback, the simulated runtime (``EngineConfig.runtime``:
per-worker straggler clocks, per-level link costs, elastic deadline drops
as masked rounds), async stale-sync execution
(``EngineConfig.async_levels``: posted snapshots folded as elementwise
deltas), the in-round divergence probes with their metrics bus and traces
(``EngineConfig.metrics``, :mod:`repro_torch.obs`) and the population
regime (``EngineConfig.population``: virtual clients sampled per round,
hydrated into the (k, ...) state and folded back into one server model,
:meth:`HSGD.run_sampled`).  The mesh refuses divergence probes on a
topology without level structure (grouped), as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.topology import SyncEvent, Topology
from repro_torch.runtime import make_runtime
from repro_torch.device import (DeviceLike, recip_f32, resolve_device,
                                uneven_split)
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Typed engine configuration, field for field the JAX package's
    (less ``jit``, which has no eager counterpart).  Subsystem fields take
    whatever their ``make_*`` factory accepts: ``executor``
    (:func:`~repro_torch.core.executors.make_executor`), ``comms``
    (:func:`~repro_torch.comms.sync.make_comms`), ``runtime``
    (:func:`~repro_torch.runtime.make_runtime`), ``metrics``
    (:func:`~repro_torch.obs.make_metrics`) and ``population``
    (:func:`~repro_torch.population.make_population`; binding one switches
    the engine into the sampled-participation regime, see
    :meth:`HSGD.run_sampled`)."""
    executor: Any = None
    comms: Any = None
    runtime: Any = None
    metrics: Any = None
    population: Any = None
    aggregate_opt_state: bool = True
    accum_steps: int = 1
    # async (stale-sync) execution: {level: staleness} — a level-l aggregate
    # is applied ``staleness`` level-l boundaries late.  staleness=0 entries
    # are dropped at construction, so {1: 0} is the barrier path bit for bit
    async_levels: Any = None

    def describe(self) -> Dict[str, Any]:
        """JSON-able summary (``launch.train``'s JSONL ``config`` line):
        the reference's, less ``jit``."""
        def show(v):
            if v is None or isinstance(v, (str, int, float, bool)):
                return v
            if isinstance(v, dict):
                return {str(k): show(x) for k, x in v.items()}
            d = getattr(v, "describe", None)
            return d() if callable(d) else repr(v)
        return {f.name: show(getattr(self, f.name))
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class HSGDState:
    """Engine state; the fields of the JAX package's, in its order."""
    params: Any      # leading worker axis n
    opt_state: Any   # leading worker axis n
    step: int        # steps taken
    comms: Any = None  # error-feedback residuals (stateful codecs), axis n
    metrics: Any = None  # probe ring (repro_torch.obs.MetricBuffer); None
    #   without a metrics plan
    pending: Any = None  # stale-sync slots ({level: StaleSlot}) under async
    #   execution; None without async levels


@dataclasses.dataclass
class StaleSnap:
    """One deferred sync payload, aggregated AT POSTING TIME: the post-fold
    worker params (and, when the engine aggregates optimizer state, the
    moments) captured at a stale level-l boundary, with the level-l
    aggregate of that very payload.  The later fold is then elementwise
    (``live + (agg - params)``): no cross-worker op runs at fold time, so a
    worker dropped at an intermediate boundary folds exactly the aggregate
    it holds.  Leaves keep the leading worker axis n.  A snapshot holds the
    very tensors the live state held when it was posted, which is safe
    because nothing on the engine's path updates a tensor in place."""
    params: Any
    opt: Any       # moments dict ({} when nothing rides the sync)
    agg: Any       # level-l aggregate of ``params``, posted with this snap
    agg_opt: Any   # level-l aggregate of ``opt`` ({} when empty)


@dataclasses.dataclass
class StaleSlot:
    """One async level's pending state: a rolling tuple of ``staleness``
    snapshots plus the level's OWN error-feedback residual chain (None
    without a stateful codec).  The live ``HSGDState.comms`` residual is
    never consumed by a stale fold, so fresh and stale syncs keep disjoint
    error-feedback streams."""
    snaps: Tuple[Any, ...]
    residual: Any = None


@dataclasses.dataclass(frozen=True)
class StaleOp:
    """One async level's static work at a round-ending sync boundary
    (computed by :func:`compile_schedule` from the schedule alone, so it is
    part of the hashable ``Round`` cache key):

    * fold the ``n_fold`` OLDEST outstanding snapshots of ``level`` into
      the live state (``live + (snap.agg - snap.params)``, elementwise) —
      ``warm`` is the number of snapshots outstanding BEFORE this op, so
      the oldest lives at slot index ``staleness - warm`` of the tuple;
    * then, when ``snapshot`` (the boundary is a level-``level`` event),
      run the level-``level`` aggregation on the post-fold payload and
      capture payload and aggregate into the newest slot.

    A boundary of a MORE global event (event.level < level) is a flush:
    ``n_fold == warm`` outstanding snapshots fold, nothing is captured,
    and the warm-up restarts."""
    level: int
    n_fold: int
    warm: int
    snapshot: bool


@dataclasses.dataclass(frozen=True)
class Round:
    """``n_local`` local updates, the last one followed by ``event`` (None
    for a round that ends between syncs — a schedule tail, or a cut forced
    by ``cut_every``).  ``stale`` carries the boundary's static async ops
    (:class:`StaleOp`, outermost last, so flushes of deeper levels apply
    first); empty for every barrier-synchronous schedule."""
    n_local: int
    event: Optional[SyncEvent]
    stale: Tuple[StaleOp, ...] = ()


def _boundary_ops(event: SyncEvent, async_levels: Dict[int, int],
                  warm: Dict[int, int]) -> Tuple[StaleOp, ...]:
    """The static stale ops one sync event triggers, updating the warm-up
    counters in place.  Deeper (more local) levels first: their outstanding
    folds are older information, and the event's own op — the only one
    that snapshots — comes last."""
    ops: List[StaleOp] = []
    for lvl in sorted(async_levels, reverse=True):
        if event.level > lvl:
            continue               # not a level-lvl boundary
        s = async_levels[lvl]
        if event.level < lvl:      # more global event: flush, restart warmup
            if warm[lvl]:
                ops.append(StaleOp(lvl, warm[lvl], warm[lvl], False))
                warm[lvl] = 0
        else:                      # the level's own boundary
            if event.groups is not None or event.weights is not None:
                raise ValueError(
                    f"async level {lvl} requires full level-{lvl} events; "
                    f"got a partial/weighted event {event} — stale folds "
                    "have no per-boundary group structure to replay")
            nf = 1 if warm[lvl] >= s else 0
            ops.append(StaleOp(lvl, nf, warm[lvl], True))
            warm[lvl] += 1 - nf
    return tuple(ops)


def async_warmup(schedule, async_levels: Dict[int, int]) -> Dict[int, int]:
    """Replay a schedule prefix's warm-up counters (how many snapshots each
    async level has outstanding after those events): what ``run_rounds``
    uses to resume a trajectory at t0 > 0 with the pending slots already
    carrying state."""
    warm = {lvl: 0 for lvl in async_levels}
    for ev in schedule:
        if ev is not None:
            _boundary_ops(ev, async_levels, warm)
    return warm


def compile_schedule(schedule, cut_every: int = 0, t0: int = 0,
                     async_levels: Optional[Dict[int, int]] = None,
                     warm0: Optional[Dict[int, int]] = None
                     ) -> Tuple[Round, ...]:
    """Fold a per-step event schedule into maximal pure-local rounds.
    ``cut_every`` additionally ends a round at every absolute step that is
    a multiple of it (``t0`` = absolute step of ``schedule[0]``).

    ``async_levels`` ({level: staleness}, entries all >= 1) annotates each
    sync round with its :class:`StaleOp`s: the first ``staleness`` level-l
    boundaries only snapshot (warm-up), every later one folds the oldest
    snapshot and captures a new one, and a more global event flushes the
    level's outstanding snapshots first.  ``warm0`` seeds the warm-up
    counters when the schedule is a suffix (:func:`async_warmup` over the
    prefix)."""
    rounds: List[Round] = []
    alv = dict(async_levels) if async_levels else {}
    warm = {lvl: 0 for lvl in alv}
    if warm0:
        warm.update(warm0)
    k = 0
    for i, ev in enumerate(schedule):
        k += 1
        if ev is not None or (cut_every and (t0 + i + 1) % cut_every == 0):
            stale = _boundary_ops(ev, alv, warm) \
                if (alv and ev is not None) else ()
            rounds.append(Round(k, ev, stale))
            k = 0
    if k:
        rounds.append(Round(k, None))
    return tuple(rounds)


def _replicate(tree, n: int):
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape))
                    .clone(), tree)


def _microbatches(x: torch.Tensor, accum: int) -> torch.Tensor:
    """``x`` as ``(accum, B // accum, ...)``: the microbatches are the
    contiguous blocks ``x[i * B // accum:(i + 1) * B // accum]``."""
    m = x.shape[0] // accum
    if uneven_split(x, 0, accum):
        # DTensor's view rule refuses to split a batch sharded unevenly
        # over the microbatches (nemotron-4-340b's 128 sequences over 16
        # ranks into 8 of 16); its split rule gathers the batch first, and
        # the even case's select gathers each microbatch all the same
        return torch.stack(torch.split(x, m, dim=0))
    return x.reshape((accum, m) + tuple(x.shape[1:]))


class HSGD:
    """The plan layer.  loss_fn(params, batch) -> (loss, metrics-dict).
    Batches carry a leading worker axis of size n; they may be numpy arrays
    or tensors, and are moved to the state's device."""

    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 topology: Topology, config: Optional[EngineConfig] = None):
        config = EngineConfig() if config is None else config
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.topology = topology
        self.config = config
        self.aggregate_opt_state = config.aggregate_opt_state
        self.accum_steps = config.accum_steps
        self.async_levels = self._normalize_async(config.async_levels)
        # local imports: executors imports this module for HSGDState/Round
        from repro_torch.comms.sync import make_comms
        self.comms = make_comms(config.comms)
        self.runtime = make_runtime(config.runtime)
        from repro_torch.obs import make_metrics
        self.metrics = make_metrics(config.metrics)
        if self.async_levels and self.metrics is not None \
                and self.metrics.divergences and not self.metrics.staleness:
            # async engines get the staleness channel next to the eq. (10)
            # partition automatically (‖applied − fresh‖² per stale fold)
            self.metrics = dataclasses.replace(self.metrics, staleness=True)
        from repro_torch.population import make_population
        self.population = make_population(config.population)
        self._population_engine = None
        self._last_clock = None
        from repro_torch.core.executors import make_executor
        self.executor = make_executor(config.executor)
        self.executor.bind(self)

    def _normalize_async(self, raw) -> Dict[int, int]:
        """Validate ``EngineConfig.async_levels`` against the topology:
        integer levels within the hierarchy, staleness >= 0, and zero
        entries dropped, so that they are the barrier path bit for bit by
        construction (same Rounds, no pending slots in the state)."""
        if not raw:
            return {}
        out: Dict[int, int] = {}
        num_levels = len(self.topology.periods)
        for lvl, s in dict(raw).items():
            lvl, s = int(lvl), int(s)
            if not 1 <= lvl <= num_levels:
                raise ValueError(
                    f"async_levels level {lvl} outside the hierarchy "
                    f"(levels 1..{num_levels})")
            if s < 0:
                raise ValueError(f"async_levels[{lvl}] = {s}: staleness "
                                 "must be >= 0")
            if s == 0:
                continue  # the barrier path
            if self.topology.participants(SyncEvent(level=lvl)) is not None:
                raise ValueError(
                    f"async level {lvl} requires every level-{lvl} event to "
                    f"cover all workers; {type(self.topology).__name__} "
                    "scopes them to a static subset (partial-group events "
                    "have no stale-fold semantics)")
            out[lvl] = s
        return out

    def participation(self, clock=None, extra=None):
        """This engine's composed Participation view: the topology's static
        event masks, plus the elastic adapter when a live clock is passed,
        plus ``extra`` (e.g. the population engine's per-round pinned
        sampler)."""
        from repro_torch.population import (ElasticParticipation,
                                            StaticParticipation, compose)
        return compose(StaticParticipation(self.topology), extra,
                       ElasticParticipation(clock)
                       if clock is not None else None)

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
        opt_state = _replicate(self.optimizer.init(params0), n)
        mbuf = self.metrics.init_buffer(self.topology, dev) \
            if self.metrics else None
        return self.executor.place(HSGDState(
            params, opt_state, 0, cstate, mbuf,
            self._init_pending(params, opt_state)))

    def _init_pending(self, params, opt_state) -> Optional[Dict]:
        """Zero-filled stale slots, one :class:`StaleSlot` per async level:
        ``staleness`` snapshots (params and the moments a sync ships) and
        the level's own error-feedback residual.  The warm-up never reads
        the zeros (each :class:`StaleOp`'s fold count is static)."""
        if not self.async_levels:
            return None
        zeros = lambda tree: tree_map(torch.zeros_like, tree)
        moments = _moments_only(opt_state) if self.aggregate_opt_state else {}
        pending: Dict[int, StaleSlot] = {}
        for lvl, s in sorted(self.async_levels.items()):
            snaps = tuple(StaleSnap(zeros(params), zeros(moments),
                                    zeros(params), zeros(moments))
                          for _ in range(s))
            res = self.comms.init_state(params) if self.comms else None
            pending[lvl] = StaleSlot(snaps, res)
        return pending

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
            mbs = tree_map(lambda x: _microbatches(x, accum), batch)
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

        grad_norm = self.metrics is not None and self.metrics.grad_norm

        def local_update(params, opt_state, batch):
            # the backward on this thread, not handed to autograd's thread
            # for the card and back: the same kernels in the same order,
            # at a lower host cost a step (thread-local; no-op on the CPU)
            with torch.autograd.set_multithreading_enabled(False):
                grads, metrics = mean_grads(params, batch)
            if grad_norm:
                # per-worker gradient l2 norm; executors mean it over the
                # worker axis like every other per-step metric.  One
                # concatenation and one sum of squares, so that the channel
                # costs four launches a step whatever the leaf count.  Not
                # torch.linalg.vector_norm: on the CPU it lies 2e-5 from
                # float64 on an LM's gradients (torch.sum sums in cascade)
                metrics = dict(metrics)
                flat = torch.cat([g.reshape(-1).to(torch.float32)
                                  for g in tree_leaves(grads)])
                metrics["grad_norm"] = torch.sqrt(torch.sum(flat * flat))
            updates, opt_state = self.optimizer.update(grads, opt_state,
                                                       params)
            params = tree_map(torch.add, params, updates)
            return params, opt_state, metrics

        return local_update

    # -- executor delegation ---------------------------------------------------
    def step_fn(self, event: Optional[SyncEvent], masked: bool = False):
        return self.executor.step_fn(event, masked)

    def round_fn(self, rnd: Round, masked: bool = False):
        """The executor's function for one round; ``masked=True`` is the
        elastic-drop variant ``(state, batches, mask)``: every worker runs
        its local updates, and workers masked out of the round's sync
        neither contribute to nor receive the aggregate."""
        return self.executor.round_fn(rnd, masked)

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
        if self.async_levels:
            raise NotImplementedError(
                "the per-step path has no stale-apply offsets (they are "
                "compiled per Round); run async engines through "
                "run_rounds, or drop async_levels from the EngineConfig")
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
                   eval_fn: Optional[Callable[[HSGDState, int], Dict]] = None,
                   trace=None, participation=None
                   ) -> Tuple[HSGDState, List[Dict]]:
        """Run T steps through the schedule-compiled executor: the schedule
        is folded into rounds (``compile_schedule``) and each runs as one
        call on the bound executor.  The trajectory is bitwise that of T
        calls of :meth:`step` (tested).

        History records per-step training metrics for every step; with
        ``eval_every`` the schedule is also cut every ``eval_every`` steps
        so ``eval_fn(state, t)`` fires exactly there (and at the end).  With
        comms on, every record carries ``wire_bytes`` — the bytes that
        step's sync moved (0 between syncs), computed statically.

        With a runtime bound, every record also carries ``sim_time_s`` (the
        simulated makespan after that step, rounded to 6 places) and
        ``sim_sync_s`` (cumulative per-level link seconds), and every sync
        step ``dropped`` (the workers the policy cut from that barrier):
        host-side numpy, no device work.  A round whose sync drops someone
        runs through ``round_fn(rnd, masked=True)``, the mask moved to the
        device once.  With ``async_levels``, the rounds carry their static
        stale ops, resumed at t0 > 0 through :func:`async_warmup`.

        With metrics on, the probe pushes one row per sync event into the
        state's :class:`~repro_torch.obs.MetricBuffer`; this loop drains it
        with ONE device-to-host copy at eval boundaries, before the ring
        could wrap and at the end, gives each row its (step, level) back
        from the schedule and merges the values into the matching records
        as ``div_global`` / ``div_up_Lℓ`` / ``div_down_Lℓ``.  Records are
        linted against the metrics bus
        (:func:`repro_torch.obs.validate_record`).

        ``trace`` takes a :class:`~repro_torch.obs.TraceRecorder`: the
        runtime clock emits per-worker compute/wait spans and per-level
        sync spans in simulated time, and drained probe rows become
        divergence counter tracks; without a runtime, spans fall back to
        step-index time.

        ``participation`` takes an extra Participation composed with the
        engine's own (topology masks and the elastic clock): each executed
        sync consults ``round_mask`` once, and a mask routes the round
        through the masked executor variant — how the population engine
        masks a draw's empty slots out of every sync."""
        t0 = state.step
        cut = eval_every if (eval_fn is not None and eval_every) else 0
        full = self.topology.schedule(t0 + T)
        schedule = full[t0:]
        warm0 = async_warmup(full[:t0], self.async_levels) \
            if (self.async_levels and t0) else None
        rounds = compile_schedule(schedule, cut_every=cut, t0=t0,
                                  async_levels=self.async_levels or None,
                                  warm0=warm0)
        wire = None
        if self.comms is not None:
            ws = self.wire_stats(state)
            wire = [ws.bytes_for_event(ev) for ev in schedule]
        clock = None
        sim: List[Tuple[float, Dict[str, float]]] = []  # per-step snapshots
        if self.runtime is not None:
            clock = self.runtime.clock(self.topology,
                                       self._payload_nbytes(state),
                                       recorder=trace,
                                       async_levels=self.async_levels or None)
            self._last_clock = clock
        parts = self.participation(clock=clock, extra=participation) \
            if (clock is not None or participation is not None) else None
        probes = (self.metrics is not None and self.metrics.divergences
                  and state.metrics is not None)
        div_keys = self.metrics.history_keys(self.topology) if probes else ()
        cap = state.metrics.capacity if probes else 0
        pending: List[Tuple[int, int]] = []  # (step, level) since last drain
        probe_vals: Dict[int, Dict[str, float]] = {}
        dev = tree_leaves(state.params)[0].device
        drops: Dict[int, int] = {}

        def ts_of(step_no: int) -> float:
            return sim[step_no - t0 - 1][0] if clock is not None \
                else float(step_no)

        def drain(st: HSGDState) -> HSGDState:
            # one device-to-host copy for everything pushed since the last
            # drain; rows get their (step, level) back from the schedule
            if not pending:
                return st
            mb = st.metrics
            k = mb.count
            assert k == len(pending) <= cap, (k, len(pending), cap)
            for (step_no, lvl), row in zip(pending, mb.rows[:k].tolist()):
                vals = {key: float(v) for key, v in zip(div_keys, row)}
                probe_vals[step_no] = vals
                if trace is not None:
                    trace.divergences(step_no, lvl, ts_of(step_no), vals)
            pending.clear()
            return dataclasses.replace(st, metrics=mb.reset())

        raw: List[Tuple[int, int, Dict]] = []  # (t_end, n_local, metrics)
        evals: Dict[int, Dict] = {}
        t = t0
        for rnd in rounds:
            batches = tuple(self._on_device(batch_fn(t + i), state)
                            for i in range(rnd.n_local))
            mask = None
            if clock is not None:
                for i in range(rnd.n_local):
                    clock.advance(t + i)
                    sim.append((clock.time_s, clock.level_seconds()))
                if rnd.event is not None:
                    mask = parts.round_mask(rnd.event)
                    # the sync belongs to the round's last step
                    sim[-1] = (clock.time_s, clock.level_seconds())
            elif parts is not None and rnd.event is not None:
                mask = parts.round_mask(rnd.event)
            if clock is None and trace is not None:
                # no runtime: keep the trace well-formed in step-index time
                trace.name_process(0, "engine")
                trace.name_thread(0, 0, "rounds (step-index time)")
                trace.complete(f"round x{rnd.n_local}", float(t),
                               float(rnd.n_local), pid=0, tid=0)
                if rnd.event is not None:
                    trace.sync_span(
                        rnd.event.level, float(t + rnd.n_local), 0.0,
                        payload_bytes=wire[t + rnd.n_local - t0 - 1]
                        if wire is not None else 0)
            if probes and rnd.event is not None and len(pending) >= cap:
                state = drain(state)   # never let the ring wrap
            if mask is None:
                state, metrics = self.round_fn(rnd)(state, batches)
            else:
                state, metrics = self.round_fn(rnd, masked=True)(
                    state, batches, torch.as_tensor(mask, device=dev))
            t += rnd.n_local
            raw.append((t, rnd.n_local, metrics))
            if rnd.event is not None:
                if probes:
                    pending.append((t, rnd.event.level))
                if clock is not None:
                    drops[t] = 0 if mask is None else int((~mask).sum())
            if eval_fn is not None and eval_every and \
                    (t % eval_every == 0 or t == t0 + T):
                if probes:
                    state = drain(state)
                evals[t] = eval_fn(state, t - 1)
        if probes:
            state = drain(state)
        # metrics stay on the device until here, one transfer per round
        history: List[Dict] = []
        for t_end, n_local, metrics in raw:
            vals = _to_host(metrics)
            for i in range(n_local):
                step_no = t_end - n_local + i + 1
                rec = {"t": step_no,
                       **{k: float(v[i]) for k, v in vals.items()}}
                if wire is not None:
                    rec["wire_bytes"] = wire[step_no - t0 - 1]
                if clock is not None:
                    time_s, sync_s = sim[step_no - t0 - 1]
                    rec["sim_time_s"] = round(time_s, 6)
                    rec["sim_sync_s"] = sync_s
                    if step_no in drops:
                        rec["dropped"] = drops[step_no]
                rec.update(probe_vals.get(step_no, {}))
                rec.update(evals.get(step_no, {}))
                history.append(rec)
        if self.metrics is not None:
            from repro_torch.obs import validate_record
            for rec in history:
                errs = validate_record(rec)
                if errs:
                    raise ValueError(
                        "metrics-bus violations in run_rounds history at "
                        f"t={rec.get('t')}: " + "; ".join(errs))
        return state, history

    def drain_metrics(self, state: HSGDState
                      ) -> Tuple[HSGDState, List[Dict[str, float]]]:
        """Drain the probe buffer outside :meth:`run_rounds` (the per-step
        :meth:`step` path pushes rows but never drains): one device-to-host
        copy; returns ``(state-with-reset-buffer, rows)``, each row a
        ``{div_*: value}`` dict in push order.  If more than
        ``Metrics.capacity`` rows were pushed since the last drain, only the
        most recent ``capacity`` survive (the ring wrapped)."""
        if self.metrics is None or state.metrics is None:
            return state, []
        mb = state.metrics
        k, cap = mb.count, mb.capacity
        order = range(k) if k <= cap \
            else [i % cap for i in range(k - cap, k)]
        keys = self.metrics.history_keys(self.topology)
        host = mb.rows.tolist()
        rows = [{key: float(v) for key, v in zip(keys, host[i])}
                for i in order]
        return dataclasses.replace(state, metrics=mb.reset()), rows

    # -- population regime -----------------------------------------------------
    def population_engine(self):
        """The lazily built :class:`~repro_torch.population.PopulationEngine`
        behind :meth:`run_sampled` (requires ``config.population``)."""
        if self.population is None:
            raise ValueError(
                "no population bound — construct the engine with "
                "EngineConfig(population=Population(cells=...)) to use the "
                "sampled-participation regime")
        if self._population_engine is None:
            from repro_torch.population import PopulationEngine
            self._population_engine = PopulationEngine(self)
        return self._population_engine

    def init_server(self, generator: torch.Generator, model_init: Callable,
                    *, device: DeviceLike = "cuda"):
        """Single-replica :class:`~repro_torch.population.ServerState` (the
        population regime's counterpart of :meth:`init` — no worker axis;
        peak state memory in this regime is bounded by k = topology.n)."""
        return self.population_engine().init_server(generator, model_init,
                                                    device=device)

    def init_server_from_params(self, params, *,
                                device: DeviceLike = "cuda"):
        """:meth:`init_server` from given params (a tree of tensors, e.g.
        the reference's exported draw), as :meth:`init_from_params`."""
        return self.population_engine().init_server_from_params(
            params, device=device)

    def run_sampled(self, server, batch_fn, rounds: int, *, sizes=None,
                    eval_every: int = 0, eval_fn=None):
        """Run ``rounds`` sampling rounds of the population regime: each
        draws k = topology.n virtual clients (hierarchically, pure in
        ``(seed, round)``), hydrates them into the (k, ...) state, runs one
        global period on the unchanged round executor, and folds the
        results back into the server model with dataset-size × staleness
        weights (``sizes``: optional ``client_id -> dataset size``, e.g.
        ``PopulationShards.client_size``).  ``batch_fn(client_ids, t)``
        returns the global step t's batch for the drawn clients (leading
        axis k).  Returns ``(ServerState, per-round history)``; each record
        carries the ``participation`` channel."""
        return self.population_engine().run(
            server, batch_fn, rounds, sizes=sizes, eval_every=eval_every,
            eval_fn=eval_fn)

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

    def audit(self, state: HSGDState, batch_fn: Optional[Callable] = None,
              *, T: Optional[int] = None, config: str = "", waivers=(),
              run: bool = True):
        """Audit of this engine's sync plan
        (:func:`repro_torch.analysis.audit_engine`): records every distinct
        SyncEvent's aggregation subprogram — and, with ``batch_fn``, every
        distinct Round's body — over one global period (or ``T`` steps),
        each once on a copy of ``state`` on its device, and lints the
        result (rules R1–R6, :mod:`repro_torch.analysis.rules`).
        ``run=False`` skips the ``run_rounds`` pass (rebuild detection then
        has no build counts).  Returns a
        :class:`~repro_torch.analysis.SyncPlanReport`."""
        from repro_torch.analysis import audit_engine
        return audit_engine(self, state, batch_fn, T=T, config=config,
                            waivers=waivers, run=run)

    def _payload_nbytes(self, state: HSGDState) -> int:
        """Per-worker bytes ONE sync payload puts on the wire, which the
        runtime clock prices: the encoded codec payload with comms on, else
        the raw bytes of everything a sync ships (params and aggregated
        optimizer moments)."""
        if self.comms is not None:
            return self.wire_stats(state).payload_bytes
        parts = [state.params]
        if self.aggregate_opt_state:
            parts.append(_moments_only(state.opt_state))
        return sum(x.nbytes // x.shape[0]
                   for tree in parts for x in tree_leaves(tree))

    def runtime_report(self, state: Optional[HSGDState] = None):
        """The last :meth:`run_rounds` clock's breakdown (simulated
        makespan, per-level sync seconds, drop counts, ...), or None before
        any run with a runtime.  ``state`` is accepted for symmetry with
        :meth:`wire_stats` and unused."""
        if self._last_clock is None:
            return None
        return self._last_clock.breakdown()

    def mean_params(self, state: HSGDState):
        """w̄^t (the analysis object; observable only at t = aG).  Under the
        mesh executor every rank gathers all workers' rows first, so this
        is the sim's arithmetic on every rank."""
        return tree_map(lambda x: x.mean(0, dtype=torch.float32).to(x.dtype),
                        self.executor.gather(state.params))

    def worker_params(self, state: HSGDState, j: int):
        """Worker j's params (under the mesh executor, from the rows every
        rank gathers, as in :meth:`mean_params`)."""
        return tree_map(lambda x: x[j], self.executor.gather(state.params))


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, List]:
    """A round's stacked per-step metrics as host lists, with one
    device-to-host copy for all channels when they share a dtype (the
    probes' ``grad_norm`` channel then costs no extra copy)."""
    keys = list(metrics)
    if len({metrics[k].dtype for k in keys}) != 1:
        return {k: v.tolist() for k, v in metrics.items()}
    return dict(zip(keys, torch.stack([metrics[k] for k in keys]).tolist()))


def _moments_only(opt_state):
    """The optimizer moments a sync aggregates; ``step`` never rides it."""
    return {k: v for k, v in opt_state.items() if k in ("m", "v")}


def _merge_moments(opt_state, agg):
    out = dict(opt_state)
    out.update(agg)
    return out


# ---------------------------------------------------------------------------
# convenience: run T steps with a data source
# ---------------------------------------------------------------------------
def run(engine: HSGD, state: HSGDState, batch_fn: Callable[[int], Any],
        T: int, eval_every: int = 0,
        eval_fn: Optional[Callable[[HSGDState, int], Dict]] = None):
    """batch_fn(t) -> batch with leading worker axis. Returns (state, history).

    History gets one record per step with the training metrics; ``eval_fn``
    results are merged into the matching step's record every
    ``eval_every`` steps."""
    history = []
    for t in range(T):
        state, metrics = engine.step(state, batch_fn(t))
        rec = {"t": t + 1, **{k: float(v) for k, v in metrics.items()}}
        if eval_every and (t + 1) % eval_every == 0 and eval_fn is not None:
            rec.update(eval_fn(state, t))
        history.append(rec)
    return state, history
