"""Recording a live :class:`~repro_torch.core.hsgd.HSGD` engine into a
report (PyTorch counterpart of ``repro.analysis.engine``).

``audit_engine`` walks one global period of the engine's schedule, records
every distinct SyncEvent's aggregation subprogram
(``executor.sync_program``) and every distinct Round's body
(``executor.round_program``), and derives the schedule-level expectations
the rules check against.  Where no exact expectation exists — grouped
topologies, weighted aggregators, ``exact=True`` replay — the audit records
the measured numbers with ``expected_* = None`` and leaves enforcement to
the budget diff (any drift from the committed baseline still fails).

The sim/mesh asymmetry is deliberate: under the mesh executor the sync IS
the ``MeshAxes`` collectives; under sim the sync is in-array reduces over
the worker axis, so sim payload figures are divided by the worker count to
get the same per-worker units the mesh reports natively.  Each call is
recorded on a copy of the state, on the state's device: on the card with
the kernels, on the CPU with their plain versions, to the same report.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from repro_torch.analysis.report import EventAudit, RoundAudit, SyncPlanReport
from repro_torch.analysis.rules import run_rules
from repro_torch.tree import tree_leaves


def event_key(event) -> str:
    if event.groups is None:
        return f"L{event.level}"
    return f"L{event.level}@" + ",".join(str(g) for g in event.groups)


def round_key(rnd) -> str:
    ev = "none" if rnd.event is None else event_key(rnd.event)
    return f"r{rnd.n_local}+{ev}"


def _encode_keys(aggregator) -> int:
    """How many wire arrays the aggregator's encode splits a value into
    (mean → 1; sign → 2: sign + magnitude)."""
    return len(aggregator.encode(torch.zeros((1, 1), dtype=torch.float32)))


def _sync_parts(eng, state):
    from repro_torch.core.hsgd import _moments_only
    parts = [state.params]
    if eng.aggregate_opt_state:
        moments = _moments_only(state.opt_state)
        if tree_leaves(moments):
            parts.append(moments)
    return parts


def _expected_sync_ops(eng, state, backend: str = "sim") -> Optional[int]:
    """Per-sync aggregation-op prediction, or None when no exact one exists.

    Legacy roundtrip lowering: ``n_arrays × encode-keys`` — dtype buckets
    per part with fused comms on, leaves per part without.  When the sync
    runs as a compressed collective (:func:`~repro_torch.core.executors.
    _wire_eligible`), the codec owns the count instead:
    ``n_arrays × codec.lowered_sync_ops(backend)`` (int8 = quantized sum
    [+ scale max under mesh], sign = vote + scale, ...).  Weighted
    aggregators add a denominator reduction per array and ``exact=True``
    replays the whole sim reduce under one gather — neither has a clean
    closed form, so both defer to the budget."""
    topo = eng.topology
    if getattr(topo, "spec", None) is None:
        return None  # grouped topologies: membership-matrix path
    if getattr(eng.executor, "exact", False):
        return None
    agg = topo.aggregator
    if agg.worker_weights(topo.n) is not None:
        return None
    if eng.comms is not None and eng.comms.bucket:
        from repro_torch.comms.flat import FlatBucket
        n_arrays = sum(len(FlatBucket.plan(p).lengths)
                       for p in _sync_parts(eng, state))
        from repro_torch.core.executors import _wire_eligible
        from repro_torch.core.topology import SyncEvent
        if _wire_eligible(eng, SyncEvent(level=1)):
            codec = eng.comms.codec
            per_array = codec.lowered_sync_ops(backend)
            if per_array is not None:
                if (codec.layout_free and not codec.stateful
                        and backend == "sim"):
                    # in-array backends elide the bucket for layout-free
                    # codecs (see Comms.sync): one reduce per LEAF
                    n_arrays = sum(len(tree_leaves(p))
                                   for p in _sync_parts(eng, state))
                return n_arrays * per_array
    else:
        n_arrays = sum(len(tree_leaves(p)) for p in _sync_parts(eng, state))
    return n_arrays * _encode_keys(agg)


def _metrics_off_twin(eng):
    """A metrics-off clone of ``eng`` (same topology/comms/runtime/executor
    settings) — the R6 baseline the metrics-on round bodies are diffed
    against."""
    from repro_torch.core.hsgd import HSGD
    return HSGD(eng.loss_fn, eng.optimizer, eng.topology,
                dataclasses.replace(eng.config, metrics=None,
                                    executor=eng.executor.twin(),
                                    comms=eng.comms, runtime=eng.runtime,
                                    population=None))


def audit_engine(eng, state, batch_fn: Optional[Callable[[int], Any]] = None,
                 *, T: Optional[int] = None, config: str = "",
                 waivers: Mapping[str, str] = (),
                 run: bool = True) -> SyncPlanReport:
    """Audit ``eng``'s sync plan; the engine-side entry point is
    :meth:`repro_torch.core.hsgd.HSGD.audit`.

    Records one global period (or ``T`` steps) of the schedule.  With
    ``batch_fn`` the distinct Rounds are recorded too (R3), and with
    ``run`` a :meth:`run_rounds` pass runs first, on a copy of the state,
    so that rebuild detection (R4) counts real builds; without
    ``batch_fn`` the report covers sync subprograms only (R1/R2/R5)."""
    topo, ex = eng.topology, eng.executor
    is_mesh = getattr(ex, "mesh", None) is not None
    n = topo.n
    horizon = int(T) if T else topo.periods[0]
    schedule = topo.schedule(horizon)

    expected_ops = _expected_sync_ops(eng, state,
                                      "mesh" if is_mesh else "sim")
    ws = eng.wire_stats(state)
    wire = None
    if ws is not None:
        wire = {"payload_bytes": ws.payload_bytes,
                "n_elements": ws.n_elements,
                "f32_bytes": ws.f32_bytes,
                "wire_dtypes": list(ws.wire_dtypes)}
    # R5 only has an exact per-worker element prediction when each array is
    # reduced once as-is: single-key encode, no weight denominators, and the
    # identity codec (a compressed collective's counted totals include scale
    # statistics / widened payloads, not the WireStats element count)
    expected_elems = None
    if ws is not None and expected_ops is not None and \
            _encode_keys(topo.aggregator) == 1 and \
            eng.comms is not None and eng.comms.codec.name == "identity":
        expected_elems = ws.n_elements

    events: Dict[str, EventAudit] = {}
    for ev in schedule:
        if ev is None:
            continue
        key = event_key(ev)
        if key in events:
            continue
        summary = ex.sync_program(ev, state)
        # sim aggregation = worker-axis reduces; the reduces of a codec
        # kernel's plain version are the kernel's arithmetic, and the
        # recorder keeps none of them (walker: kernel regions)
        ops = summary.collectives if is_mesh else summary.reduces
        elements = sum(o.elements for o in ops)
        nbytes = sum(o.nbytes for o in ops)
        f32_elements = sum(o.elements for o in ops
                           if "float32" in o.dtypes)
        if not is_mesh:  # sim reduces carry the full (n, ...) worker axis
            elements //= n
            nbytes //= n
            f32_elements //= n
        events[key] = EventAudit(
            key=key, level=ev.level, groups=ev.groups,
            sync_ops=len(ops), expected_sync_ops=expected_ops,
            ops=ops,
            axes=tuple(sorted({a for o in ops for a in o.axes})),
            wire_dtypes=tuple(sorted({d for o in ops for d in o.dtypes})),
            payload_elements=elements, payload_bytes=nbytes,
            expected_payload_elements=expected_elems,
            f32_elements=f32_elements, kernels=summary.kernels)

    rounds: Dict[str, RoundAudit] = {}
    probes = None
    if batch_fn is not None:
        from repro_torch.core.hsgd import Round, compile_schedule
        twin = tstate = None
        if eng.metrics is not None:
            # R6: diff every round body against its metrics-off twin — the
            # probe may add neither host reads/transfers nor more than the
            # Metrics plan's declared op budget
            twin = _metrics_off_twin(eng)
            tstate = dataclasses.replace(state, metrics=None)
            probes = {"budget": eng.metrics.op_budget(
                "mesh" if is_mesh else "sim", topo,
                len(tree_leaves(state.params))), "rounds": {}}

        def agg_ops(summary) -> int:
            # same measure as the event audits: collectives under mesh,
            # in-array reduces under sim
            if is_mesh:
                return summary.collective_count
            return len(summary.reduces)

        if run:
            eng.run_rounds(copy.deepcopy(state), batch_fn, horizon)
        for rnd in dict.fromkeys(compile_schedule(schedule)):
            batches = tuple(batch_fn(i) for i in range(rnd.n_local))
            summary = ex.round_program(rnd, state, batches)
            fn = ex.round_fn(rnd)
            rounds[round_key(rnd)] = RoundAudit(
                key=round_key(rnd), n_local=rnd.n_local,
                event=None if rnd.event is None else event_key(rnd.event),
                collective_count=summary.collective_count,
                callbacks=tuple(f"{o.primitive}@{o.path}"
                                for o in summary.callbacks),
                transfers=tuple(f"{o.primitive}@{o.path}"
                                for o in summary.transfers),
                cache_stable=fn is ex.round_fn(Round(rnd.n_local, rnd.event)),
                jit_cache_size=ex.round_builds(rnd) if run else None)
            if twin is not None:
                tsum = twin.executor.round_program(rnd, tstate, batches)
                probes["rounds"][round_key(rnd)] = {
                    "extra_ops": agg_ops(summary) - agg_ops(tsum),
                    "extra_callbacks":
                        len(summary.callbacks) - len(tsum.callbacks),
                    "extra_transfers":
                        len(summary.transfers) - len(tsum.transfers),
                }

    report = SyncPlanReport(
        config=config,
        executor="mesh" if is_mesh else "sim",
        topology=type(topo).__name__,
        aggregator=type(topo.aggregator).__name__,
        codec=None if eng.comms is None else eng.comms.codec.name,
        events=events, rounds=rounds, wire=wire, probes=probes)
    return dataclasses.replace(
        report, findings=tuple(run_rules(report, waivers)))
