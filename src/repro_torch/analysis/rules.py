"""The lint rules over a :class:`~repro_torch.analysis.report.
SyncPlanReport` (PyTorch counterpart of ``repro.analysis.rules``, copied:
the rules read plain data only).

Each rule is a pure function ``rule(report) -> [Finding]`` operating on the
report's plain data — never on a live program — so every rule is testable
from a hand-built report fixture.  The catalog (the reference's, with what
the port's recorder counts for R3 and R4):

* **R1 sync-op count** — each event's lowered sync-op count must equal the
  schedule-derived expectation: ``buckets × encode-keys`` with comms on
  (O(dtypes)), ``leaves × encode-keys`` without (O(leaves)).  Skipped when
  no exact prediction exists (grouped topology, weighted aggregator,
  ``exact=True``) — those configs are pinned by the budget diff instead.
* **R2 no-f32-on-the-wire** — with a *compressing* codec active, float32
  must be a strict minority of what the lowered sync ops move:
  ``f32_elements > payload_elements // 2`` fires.  The compressed-
  allreduce lowering keeps the encoded payload on the collective (int8
  psums as a widened int32, sign votes as unpacked bits, top-k all-gathers
  its sparse (values, indices) payload), so only small scale statistics —
  and the f32 half of a top-k payload — may ride in f32.  The legacy
  encode→reduce(f32)→decode roundtrip (``Comms(wire_reduce=False)``)
  decodes BEFORE the reduction and still fires on every compressing
  config.  Reports predating the ``f32_elements`` field fall back to the
  original any-f32-dtype check.
* **R3 host-free round body** — no host reads and no device transfers
  inside a recorded round call (:mod:`.walker`): one round must stay one
  stream of device work.  Host reads are ``aten._local_scalar_dense``
  (``.item()``, ``float(t)``, ``bool(t)``), ``.tolist()``, ``.numpy()``,
  printing a tensor and the ops whose output shape depends on the data
  (``nonzero``, boolean indexing, ``unique``, ...); each waits for the
  device.  Transfers are copies that change device, and tensors built
  from host data (``torch.tensor``/``torch.as_tensor`` of Python or numpy
  values, ``aten.lift_fresh``): on the card such a constant is a
  synchronizing copy from pageable memory, so R3 counts it on every
  device, the CPU included, where it costs nothing; a copy to the host is
  a transfer only where there is a device to leave (on the CPU
  ``t.cpu()`` is no op at all).  A mesh collective's staging through the
  host under ``gloo`` is the collective itself, not a transfer.  The
  recorded call follows one unrecorded call, so a cache that a body fills
  once (the probes' grouping constants) is not counted.
* **R4 rebuild detection** — each Round signature is built exactly once
  across ``run_rounds``: the executor's round cache returns a stable
  callable, and its build counter (the port's counterpart of the jit
  cache size) holds at most one build per signature.
* **R5 wire-accounting cross-check** — the per-worker elements the lowered
  sync ops consume must equal the static ``WireStats`` element count:
  accounting (what history's ``wire_bytes`` reports) may not drift from
  reality (what the program moves).
* **R6 probe overhead** — a metrics-on round body must add ZERO host
  callbacks and zero device transfers versus its metrics-off twin
  (observability may never reintroduce the per-step host sync R3 banned),
  and at most ``Metrics.op_budget`` extra aggregation ops (the declared
  cost of the in-graph divergence probe + grad-norm channel).  Skipped on
  reports without a ``probes`` block (engine audited with metrics off).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping

from repro_torch.analysis.report import Finding, SyncPlanReport


def rule_r1_sync_op_count(report: SyncPlanReport) -> List[Finding]:
    out = []
    for key, ev in sorted(report.events.items()):
        if ev.expected_sync_ops is None:
            continue
        if ev.sync_ops != ev.expected_sync_ops:
            out.append(Finding(
                "R1", key,
                f"lowered sync has {ev.sync_ops} aggregation op(s), "
                f"schedule predicts {ev.expected_sync_ops}"))
    return out


def rule_r2_wire_dtypes(report: SyncPlanReport) -> List[Finding]:
    if report.codec in (None, "identity"):
        return []
    out = []
    for key, ev in sorted(report.events.items()):
        if ev.f32_elements is None:
            # report predates the element accounting: dtype-presence check
            if "float32" in ev.wire_dtypes:
                out.append(Finding(
                    "R2", key,
                    f"compressing codec '{report.codec}' is active but the "
                    f"lowered sync reduces float32 — the "
                    f"encode→reduce→decode path decodes BEFORE the "
                    f"reduction, so compression never reaches the wire"))
        elif ev.f32_elements > ev.payload_elements // 2:
            out.append(Finding(
                "R2", key,
                f"compressing codec '{report.codec}' is active but "
                f"{ev.f32_elements} of the {ev.payload_elements} "
                f"elements/worker the lowered sync moves are float32 — "
                f"the payload is decoded before it reaches the collective, "
                f"so the declared compression never reaches the wire"))
    return out


def rule_r3_host_free(report: SyncPlanReport) -> List[Finding]:
    out = []
    for key, rnd in sorted(report.rounds.items()):
        for kind, ops in (("host callback", rnd.callbacks),
                          ("device transfer", rnd.transfers)):
            for op in ops:
                out.append(Finding(
                    "R3", key, f"{kind} '{op}' inside the round body"))
    return out


def rule_r4_retrace(report: SyncPlanReport) -> List[Finding]:
    out = []
    for key, rnd in sorted(report.rounds.items()):
        if not rnd.cache_stable:
            out.append(Finding(
                "R4", key,
                "executor round cache returned a different callable for an "
                "equal Round signature"))
        if rnd.jit_cache_size is not None and rnd.jit_cache_size > 1:
            out.append(Finding(
                "R4", key,
                f"round signature built {rnd.jit_cache_size} times across "
                f"run_rounds (expected once)"))
    return out


def rule_r5_wire_accounting(report: SyncPlanReport) -> List[Finding]:
    out = []
    for key, ev in sorted(report.events.items()):
        if ev.expected_payload_elements is None:
            continue
        if ev.payload_elements != ev.expected_payload_elements:
            out.append(Finding(
                "R5", key,
                f"lowered sync consumes {ev.payload_elements} elements/worker "
                f"but WireStats accounts {ev.expected_payload_elements} — "
                f"static accounting drifted from the lowered program"))
    return out


def rule_r6_probe_overhead(report: SyncPlanReport) -> List[Finding]:
    if report.probes is None:
        return []
    out = []
    budget = int(report.probes.get("budget", 0))
    for key, d in sorted(report.probes.get("rounds", {}).items()):
        cbs = int(d.get("extra_callbacks", 0))
        xfs = int(d.get("extra_transfers", 0))
        if cbs > 0 or xfs > 0:
            out.append(Finding(
                "R6", key,
                f"metrics-on round body adds {cbs} host callback(s) and "
                f"{xfs} device transfer(s) vs its metrics-off twin — the "
                f"probe must stay in-graph (drained in bulk, never per "
                f"round)"))
        extra = int(d.get("extra_ops", 0))
        if extra > budget:
            out.append(Finding(
                "R6", key,
                f"metrics-on round body adds {extra} aggregation op(s) vs "
                f"its metrics-off twin, over the declared probe budget of "
                f"{budget}"))
    return out


RULES: Dict[str, Callable[[SyncPlanReport], List[Finding]]] = {
    "R1": rule_r1_sync_op_count,
    "R2": rule_r2_wire_dtypes,
    "R3": rule_r3_host_free,
    "R4": rule_r4_retrace,
    "R5": rule_r5_wire_accounting,
    "R6": rule_r6_probe_overhead,
}


def run_rules(report: SyncPlanReport,
              waivers: Mapping[str, str] = ()) -> List[Finding]:
    """Run every rule; mark findings whose rule id appears in ``waivers``
    (``{rule_id: reason}``) as waived rather than dropping them — a waived
    finding stays visible in the report and the budget, it just does not
    fail a check."""
    waivers = dict(waivers or {})
    findings: List[Finding] = []
    for rule_id, rule in RULES.items():
        for f in rule(report):
            if rule_id in waivers:
                f = Finding(f.rule, f.subject, f.message, waived=True,
                            waive_reason=waivers[rule_id])
            findings.append(f)
    return findings
