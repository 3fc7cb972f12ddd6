"""Chrome-trace-event / Perfetto export of a training run's timeline (the
PyTorch port's copy of ``repro.obs.trace``, code unchanged).

:class:`TraceRecorder` collects trace events while the engine runs —
per-worker compute spans and barrier waits from the
:class:`~repro_torch.runtime.SimClock` hooks, per-level sync spans annotated with
wire bytes and drop counts, and divergence counter tracks from the drained
in-graph probes — and serializes them in the Chrome trace-event JSON object
format (``{"traceEvents": [...]}``), which Perfetto and ``chrome://tracing``
open directly.

Track layout (pid/tid are just track labels in this format):

* pid 0 ``workers`` — one tid per worker: compute spans (``X``), barrier
  waits (``X``, name ``wait Lℓ``);
* pid 1 ``barriers`` — one tid per hierarchy level: each sync event's link
  span, args carrying ``payload_bytes`` / ``level`` / ``dropped``;
* pid 2 ``probes``   — counter tracks (``C``): one series per divergence
  channel, emitted at the probe's sync step.

Timestamps are microseconds (the format's unit).  With a runtime model
bound they are simulated seconds × 1e6; without one the recorder falls
back to step-index time (1 step = 1 "second") so traces stay well-formed
— the README quickstart documents both.

:func:`validate_trace` is the schema check CI and the tests run over every
exported trace: object-format envelope, required per-event fields, known
phases, non-negative timestamps/durations.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Optional

from repro_torch.obs.bus import SCHEMA_VERSION

_US = 1e6  # seconds -> microseconds (the trace-event unit)

# phases this exporter emits (subset of the trace-event format)
_PHASES = ("X", "i", "C", "M")


class TraceRecorder:
    """Accumulates trace events; hand one to ``run_rounds(..., trace=...)``
    (and it is threaded into the runtime clock automatically)."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._named: set = set()

    # -- track naming --------------------------------------------------------
    def name_process(self, pid: int, name: str) -> None:
        key = ("p", pid)
        if key in self._named:
            return
        self._named.add(key)
        self.events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": name}})

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        key = ("t", pid, tid)
        if key in self._named:
            return
        self._named.add(key)
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    # -- event emitters (ts/dur in SECONDS; converted here) ------------------
    def complete(self, name: str, ts_s: float, dur_s: float, *, pid: int,
                 tid: int, args: Optional[Mapping] = None) -> None:
        ev = {"name": name, "ph": "X", "ts": round(ts_s * _US, 3),
              "dur": round(max(dur_s, 0.0) * _US, 3), "pid": pid, "tid": tid}
        if args:
            ev["args"] = dict(args)
        self.events.append(ev)

    def instant(self, name: str, ts_s: float, *, pid: int, tid: int,
                args: Optional[Mapping] = None) -> None:
        ev = {"name": name, "ph": "i", "ts": round(ts_s * _US, 3),
              "pid": pid, "tid": tid, "s": "t"}
        if args:
            ev["args"] = dict(args)
        self.events.append(ev)

    def counter(self, name: str, ts_s: float, values: Mapping[str, float], *,
                pid: int) -> None:
        self.events.append({"name": name, "ph": "C",
                            "ts": round(ts_s * _US, 3), "pid": pid, "tid": 0,
                            "args": {k: float(v) for k, v in values.items()}})

    # -- the engine-facing convenience hooks ---------------------------------
    def compute_span(self, worker: int, ts_s: float, dur_s: float) -> None:
        self.name_process(0, "workers")
        self.name_thread(0, worker, f"worker {worker}")
        self.complete("compute", ts_s, dur_s, pid=0, tid=worker)

    def wait_span(self, worker: int, level: int, ts_s: float,
                  dur_s: float) -> None:
        self.name_process(0, "workers")
        self.name_thread(0, worker, f"worker {worker}")
        self.complete(f"wait L{level}", ts_s, dur_s, pid=0, tid=worker)

    def sync_span(self, level: int, ts_s: float, dur_s: float,
                  *, payload_bytes: int = 0, dropped: int = 0,
                  extra: Optional[Mapping] = None) -> None:
        self.name_process(1, "barriers")
        self.name_thread(1, level, f"L{level}")
        args = {"level": level, "payload_bytes": int(payload_bytes),
                "dropped": int(dropped)}
        if extra:
            args.update(extra)
        self.complete(f"sync L{level}", ts_s, dur_s, pid=1, tid=level,
                      args=args)

    def divergences(self, step: int, level: int, ts_s: float,
                    values: Mapping[str, float]) -> None:
        self.name_process(2, "probes")
        self.counter("divergence", ts_s, values, pid=2)
        self.instant(f"probe t={step}", ts_s, pid=1, tid=level,
                     args={"step": step, **{k: float(v)
                                            for k, v in values.items()}})

    # -- serialization -------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            # the exporter tag names the trace format, which the port
            # shares with the JAX package, so one tool reads both
            "otherData": {"exporter": "repro.obs",
                          "schema_version": SCHEMA_VERSION},
        }

    def save(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f, indent=1)


def validate_trace(obj) -> List[str]:
    """Schema-check a trace (parsed JSON object or a TraceRecorder).
    Returns the list of violations (empty = valid Chrome-trace-event
    object format, as this exporter emits it)."""
    if isinstance(obj, TraceRecorder):
        obj = obj.to_json()
    errors: List[str] = []
    if not isinstance(obj, Mapping):
        return [f"trace must be a JSON object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["trace object lacks a 'traceEvents' list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, Mapping):
            errors.append(f"{where}: not an object")
            continue
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                errors.append(f"{where}: missing required field {field!r}")
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}: unknown phase {ph!r} "
                          f"(exporter emits {_PHASES})")
            continue
        if ph != "M" and "ts" not in ev:
            errors.append(f"{where}: {ph!r} event missing 'ts'")
        if "ts" in ev and not (isinstance(ev["ts"], (int, float))
                               and ev["ts"] >= 0):
            errors.append(f"{where}: 'ts' must be a non-negative number")
        if ph == "X":
            if "dur" not in ev:
                errors.append(f"{where}: complete event missing 'dur'")
            elif not (isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0):
                errors.append(f"{where}: 'dur' must be a non-negative number")
        if ph == "C" and not isinstance(ev.get("args"), Mapping):
            errors.append(f"{where}: counter event needs numeric 'args'")
    return errors
