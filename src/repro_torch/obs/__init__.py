"""repro_torch.obs — the observability layer (counterpart of
``repro.obs``): in-round probes, the metrics bus, traces.

* **probes** (:mod:`.probes`) — ``EngineConfig(metrics="on")`` carries a
  :class:`MetricBuffer` in the training state and pushes the paper's
  per-level parameter divergences (eq. (10): global = upward + downward)
  at every sync event, on the device, inside the round body; drained with
  one device-to-host copy at eval boundaries.  ``metrics=None`` (default)
  is bit for bit the engine without observability.
* **bus** (:mod:`.bus`) — the typed channel registry
  (:func:`register_metric` / :class:`MetricSpec`) and record linter
  (:func:`validate_record`) every telemetry producer emits through.
* **trace** (:mod:`.trace`) — :class:`TraceRecorder` exports the run as
  Chrome-trace-event/Perfetto JSON (``python -m repro_torch.obs`` is the
  CLI; ``run_rounds(..., trace=recorder)`` the engine hook).
"""
from repro_torch.obs.bus import (SCHEMA_VERSION, MetricSpec, register_metric,
                                 registered_metrics, spec_for,
                                 validate_record)
from repro_torch.obs.probes import (MetricBuffer, Metrics, MetricsLike,
                                    make_metrics)
from repro_torch.obs.trace import TraceRecorder, validate_trace

__all__ = [
    "Metrics", "MetricsLike", "MetricBuffer", "make_metrics",
    "MetricSpec", "SCHEMA_VERSION", "register_metric", "registered_metrics",
    "spec_for", "validate_record",
    "TraceRecorder", "validate_trace",
]
