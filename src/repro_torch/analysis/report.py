"""The :class:`SyncPlanReport` — what an engine's programs ship (PyTorch
counterpart of ``repro.analysis.report``, copied: plain data only).

Everything here is plain JSON-able data.  The engine (:mod:`.engine`)
produces a report by recording live executors; the rules (:mod:`.rules`)
and the budget differ (:mod:`.budget`) consume reports — and because a
report round-trips through ``to_dict``/``from_dict``, rule and budget tests
can fabricate arbitrary good/bad reports without ever running a program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.analysis.walker import OpRecord


@dataclasses.dataclass(frozen=True)
class EventAudit:
    """The recorded sync subprogram of ONE distinct SyncEvent.

    ``sync_ops`` counts the operations that realize the aggregation: the
    ``MeshAxes`` collectives under the mesh executor, the in-array reduces
    (``aten.sum``/``aten.mean`` and the products) under sim.  ``expected_sync_ops`` is the
    schedule-derived prediction (O(dtype buckets)·keys with comms on,
    O(leaves)·keys without) — None when no exact prediction exists (grouped
    topologies, weighted aggregators, ``exact=True`` replay), in which case
    R1/R5 defer to the budget diff instead.  Payload figures are per worker.
    """
    key: str                              # "L2", "L1@0,2", ...
    level: int
    groups: Optional[Tuple[int, ...]]
    sync_ops: int
    expected_sync_ops: Optional[int]
    ops: Tuple[OpRecord, ...]             # the sync_ops records themselves
    axes: Tuple[str, ...]                 # union of named axes (mesh)
    wire_dtypes: Tuple[str, ...]          # distinct operand dtypes
    payload_elements: int
    payload_bytes: int
    expected_payload_elements: Optional[int]  # from WireStats (R5), if exact
    f32_elements: Optional[int] = None    # elements of float32 sync operands
    #   (R2: a compressing codec must keep f32 a strict minority of the
    #   payload; None on reports predating the field -> R2 dtype fallback)
    kernels: Tuple[str, ...] = ()         # the port's kernel regions, in
    #   call order: the hand-written kernels one sync launches (on the card)
    #   or whose plain versions it runs (on the CPU)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ops"] = [o.to_dict() for o in self.ops]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EventAudit":
        return cls(
            key=d["key"], level=int(d["level"]),
            groups=None if d.get("groups") is None else tuple(d["groups"]),
            sync_ops=int(d["sync_ops"]),
            expected_sync_ops=(None if d.get("expected_sync_ops") is None
                               else int(d["expected_sync_ops"])),
            ops=tuple(OpRecord.from_dict(o) for o in d.get("ops", ())),
            axes=tuple(d.get("axes", ())),
            wire_dtypes=tuple(d.get("wire_dtypes", ())),
            payload_elements=int(d.get("payload_elements", 0)),
            payload_bytes=int(d.get("payload_bytes", 0)),
            expected_payload_elements=(
                None if d.get("expected_payload_elements") is None
                else int(d["expected_payload_elements"])),
            f32_elements=(None if d.get("f32_elements") is None
                          else int(d["f32_elements"])),
            kernels=tuple(d.get("kernels", ())))


@dataclasses.dataclass(frozen=True)
class RoundAudit:
    """The recorded program of ONE distinct ``Round`` signature.

    ``callbacks``/``transfers`` are ``"op@site"`` strings for every host
    read or device transfer found inside the recorded round body (rule R3
    requires both empty).  ``cache_stable`` asserts the executor returns
    the SAME callable for an equal Round (the plan-layer cache);
    ``jit_cache_size`` keeps the reference's name for the port's count of
    builds of the signature's round body after a ``run_rounds`` pass — >1
    means the signature was rebuilt (R4).
    """
    key: str                              # "r4+L1", "r4+none", ...
    n_local: int
    event: Optional[str]                  # EventAudit key, or None
    collective_count: int
    callbacks: Tuple[str, ...]
    transfers: Tuple[str, ...]
    cache_stable: bool
    jit_cache_size: Optional[int]         # None when not measurable

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RoundAudit":
        return cls(
            key=d["key"], n_local=int(d["n_local"]), event=d.get("event"),
            collective_count=int(d.get("collective_count", 0)),
            callbacks=tuple(d.get("callbacks", ())),
            transfers=tuple(d.get("transfers", ())),
            cache_stable=bool(d.get("cache_stable", True)),
            jit_cache_size=(None if d.get("jit_cache_size") is None
                            else int(d["jit_cache_size"])))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule firing.  ``waived`` findings are known-and-accepted baseline
    facts (recorded in the budget's ``waivers`` with a reason); they stay in
    the report so the debt is visible, but do not fail a ``--check``."""
    rule: str        # "R1".."R5"
    subject: str     # event/round key (or "" for report-wide)
    message: str
    waived: bool = False
    waive_reason: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Finding":
        return cls(d["rule"], d.get("subject", ""), d.get("message", ""),
                   bool(d.get("waived", False)), d.get("waive_reason", ""))


@dataclasses.dataclass(frozen=True)
class SyncPlanReport:
    """The full audit of one engine configuration."""
    config: str                            # config name ("sim/two_level/int8")
    executor: str                          # "sim" | "mesh" | class name
    topology: str
    aggregator: str
    codec: Optional[str]                   # codec name, None with comms off
    events: Dict[str, EventAudit]
    rounds: Dict[str, RoundAudit]
    wire: Optional[Dict[str, Any]]         # WireStats-declared accounting
    findings: Tuple[Finding, ...] = ()
    probes: Optional[Dict[str, Any]] = None
    #   metrics-on overhead accounting (rule R6), None when the audited
    #   engine has no observability plan: {"budget": max extra ops the
    #   Metrics plan declares, "rounds": {round key: {"extra_ops",
    #   "extra_callbacks", "extra_transfers"} vs the metrics-off twin}}

    @property
    def unwaived(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if not f.waived)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "config": self.config, "executor": self.executor,
            "topology": self.topology, "aggregator": self.aggregator,
            "codec": self.codec,
            "events": {k: v.to_dict() for k, v in sorted(self.events.items())},
            "rounds": {k: v.to_dict() for k, v in sorted(self.rounds.items())},
            "wire": self.wire,
            "findings": [f.to_dict() for f in self.findings],
            "probes": self.probes,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SyncPlanReport":
        return cls(
            config=d.get("config", ""), executor=d.get("executor", ""),
            topology=d.get("topology", ""),
            aggregator=d.get("aggregator", ""), codec=d.get("codec"),
            events={k: EventAudit.from_dict(v)
                    for k, v in d.get("events", {}).items()},
            rounds={k: RoundAudit.from_dict(v)
                    for k, v in d.get("rounds", {}).items()},
            wire=d.get("wire"),
            findings=tuple(Finding.from_dict(f)
                           for f in d.get("findings", ())),
            probes=d.get("probes"))

    # -- display -------------------------------------------------------------
    def summary(self) -> str:
        """Human-readable audit summary (``--audit`` / CLI output)."""
        lines = [f"[{self.config or self.executor}] executor={self.executor} "
                 f"topology={self.topology} aggregator={self.aggregator} "
                 f"codec={self.codec or 'off'}"]
        for key, ev in sorted(self.events.items()):
            exp = ("" if ev.expected_sync_ops is None
                   else f" (expected {ev.expected_sync_ops})")
            axes = f" axes={','.join(ev.axes)}" if ev.axes else ""
            lines.append(
                f"  sync {key}: {ev.sync_ops} op(s){exp}{axes} "
                f"dtypes={','.join(ev.wire_dtypes) or '-'} "
                f"payload={ev.payload_bytes}B/worker")
        for key, rnd in sorted(self.rounds.items()):
            extras = []
            if rnd.callbacks:
                extras.append(f"callbacks={len(rnd.callbacks)}")
            if rnd.transfers:
                extras.append(f"transfers={len(rnd.transfers)}")
            if rnd.jit_cache_size is not None:
                extras.append(f"traces={rnd.jit_cache_size}")
            lines.append(f"  round {key}: {rnd.collective_count} "
                         f"collective(s) {' '.join(extras)}".rstrip())
        if self.wire is not None:
            lines.append(f"  wire: {self.wire['payload_bytes']}B/worker "
                         f"declared, dtypes="
                         f"{','.join(self.wire['wire_dtypes'])}")
        if self.probes is not None:
            for key, d in sorted(self.probes.get("rounds", {}).items()):
                lines.append(
                    f"  probes {key}: +{d.get('extra_ops', 0)} op(s) vs "
                    f"metrics-off (budget {self.probes.get('budget', 0)}), "
                    f"+{d.get('extra_callbacks', 0)} callback(s), "
                    f"+{d.get('extra_transfers', 0)} transfer(s)")
        for f in self.findings:
            tag = "waived" if f.waived else "FINDING"
            why = f" [{f.waive_reason}]" if f.waived else ""
            lines.append(f"  {tag} {f.rule} {f.subject}: {f.message}{why}")
        if not self.findings:
            lines.append("  findings: none")
        return "\n".join(lines)
