"""The metrics bus: one typed, versioned schema for every telemetry channel
(the PyTorch port's copy of ``repro.obs.bus``, code unchanged).

Before this module the repo's telemetry was an ad-hoc union of dict keys —
``run_rounds`` history carried the loss-aux metrics plus ``wire_bytes`` /
``sim_time_s`` / ``sim_sync_s``, ``launch/train.py`` emitted its own JSONL
shape, and the benchmarks theirs — with nothing checking that a producer's
key still meant what a consumer expected.  The bus is that check:

* :class:`MetricSpec` declares one channel — exact name or fnmatch pattern
  (``div_up_L*``), value kind (scalar / int / mapping), producing layer —
  and :func:`register_metric` puts it in the process-wide registry;
* :func:`validate_record` lints one per-step record against the registry:
  a known channel carrying the wrong kind is always an error; unknown keys
  are errors only under ``strict=True`` (``run_rounds`` validates leniently
  so user ``eval_fn`` extras pass through; ``launch/train.py`` and the
  benchmarks validate their own fully-registered records strictly);
* ``SCHEMA_VERSION`` stamps exported artifacts (train JSONL header, trace
  metadata, BENCH_obs.json) so downstream tooling can detect shape changes.

Every channel the engine emits today is pre-registered below; new
subsystems register theirs at import time (the registry is additive —
re-registering the same name needs ``overwrite=True``).
"""
from __future__ import annotations

import dataclasses
import numbers
from fnmatch import fnmatch
from typing import Dict, List, Mapping, Optional, Tuple

SCHEMA_VERSION = 1

# value kinds a channel may declare
_KINDS = ("scalar", "int", "mapping")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One telemetry channel.  ``name`` may be an fnmatch pattern so one
    spec covers a per-level family (``div_up_L*``)."""
    name: str
    kind: str = "scalar"        # "scalar" | "int" | "mapping"
    source: str = "engine"      # producing layer (engine/probe/comms/...)
    units: str = ""
    doc: str = ""

    def __post_init__(self):
        assert self.kind in _KINDS, self
        assert self.name, self

    def matches(self, key: str) -> bool:
        return key == self.name or fnmatch(key, self.name)

    def check(self, value) -> Optional[str]:
        """None if ``value`` fits this channel's kind, else the complaint."""
        if self.kind == "mapping":
            if not isinstance(value, Mapping):
                return f"expected a mapping, got {type(value).__name__}"
        elif self.kind == "int":
            if isinstance(value, bool) or \
                    not isinstance(value, numbers.Integral):
                return f"expected an integer, got {type(value).__name__}"
        elif not isinstance(value, numbers.Real) or isinstance(value, bool):
            return f"expected a real scalar, got {type(value).__name__}"
        return None


_REGISTRY: Dict[str, MetricSpec] = {}


def register_metric(spec: MetricSpec, *, overwrite: bool = False) -> MetricSpec:
    if not overwrite and spec.name in _REGISTRY:
        raise ValueError(f"metric {spec.name!r} is already registered "
                         f"({_REGISTRY[spec.name]}); pass overwrite=True "
                         f"to replace it")
    _REGISTRY[spec.name] = spec
    return spec


def registered_metrics() -> Tuple[MetricSpec, ...]:
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


def spec_for(key: str) -> Optional[MetricSpec]:
    """The spec covering ``key``: exact name first, then the first (sorted)
    matching pattern."""
    spec = _REGISTRY.get(key)
    if spec is not None:
        return spec
    for name in sorted(_REGISTRY):
        if _REGISTRY[name].matches(key):
            return _REGISTRY[name]
    return None


def validate_record(rec: Mapping, *, strict: bool = False) -> List[str]:
    """Lint one telemetry record.  Returns the list of complaints (empty =
    valid).  Kind mismatches on registered channels always complain;
    unregistered keys only under ``strict``."""
    errors: List[str] = []
    for key, value in rec.items():
        spec = spec_for(key)
        if spec is None:
            if strict:
                errors.append(f"unregistered metric {key!r}")
            continue
        err = spec.check(value)
        if err is not None:
            errors.append(f"{key}: {err} (channel {spec.name!r}, "
                          f"kind {spec.kind})")
    return errors


# -- the engine's pre-registered channels ------------------------------------
for _spec in (
    MetricSpec("t", "int", "engine", "step", "1-indexed step number"),
    MetricSpec("step", "int", "launch", "step", "JSONL step number"),
    MetricSpec("ce", "scalar", "engine", "nats",
               "per-step training cross-entropy (worker mean)"),
    MetricSpec("loss", "scalar", "launch", "nats", "eval loss at w̄"),
    MetricSpec("acc", "scalar", "launch", "", "eval accuracy at w̄"),
    MetricSpec("lvl", "int", "launch", "level",
               "sync level fired after this step (absent/None between syncs)"),
    MetricSpec("grad_norm", "scalar", "probe", "l2",
               "worker-mean gradient l2 norm (Metrics.grad_norm channel)"),
    MetricSpec("wire_bytes", "int", "comms", "bytes",
               "bytes this step's sync moved (0 between syncs)"),
    MetricSpec("wire_cum_bytes", "int", "comms", "bytes",
               "cumulative wire bytes (train JSONL)"),
    MetricSpec("sim_time_s", "scalar", "runtime", "s",
               "cumulative simulated makespan"),
    MetricSpec("sim_sync_s", "mapping", "runtime", "s/level",
               "cumulative per-level barrier link seconds"),
    MetricSpec("dropped", "int", "runtime", "workers",
               "workers dropped from this step's sync (0 = full barrier)"),
    MetricSpec("div_global", "scalar", "probe", "param²",
               "global parameter divergence at this step's sync event"),
    MetricSpec("div_up_L*", "scalar", "probe", "param²",
               "upward divergence between level-ℓ subtree means (eq. 10)"),
    MetricSpec("div_down_L*", "scalar", "probe", "param²",
               "mean downward divergence within level-ℓ subtrees (eq. 10)"),
    MetricSpec("div_staleness", "scalar", "probe", "param²",
               "async stale-sync price: worker-mean ‖applied − fresh‖² at "
               "stale fold boundaries (0 at fresh events and warm-up)"),
    MetricSpec("divergence", "mapping", "launch", "param²/level",
               "host-oracle gradient divergences (all_divergences)"),
    MetricSpec("elapsed_s", "scalar", "launch", "s", "wall-clock elapsed"),
    MetricSpec("round", "int", "population", "round",
               "1-indexed sampling-round number (population regime)"),
    MetricSpec("participation", "mapping", "population", "clients",
               "per-round sampled-participation summary: k, population, "
               "cells, active, stale_slots, reseen, unique"),
):
    register_metric(_spec)
del _spec
