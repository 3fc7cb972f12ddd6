"""repro_torch.runtime — simulated-time heterogeneity for H-SGD schedules
(a copy of ``repro.runtime``, which is numpy only; the port keeps its own
so that it imports nothing of the JAX package).

Three parts (see the module docstrings for the design notes):

* :mod:`repro_torch.runtime.clock` — ``RuntimeModel`` / ``SimClock``: event-driven
  per-worker clocks, per-level link models priced by the wire
  accounting (codecs visibly buy time), exact monotonicity and
  elastic-never-slower invariants;
* :mod:`repro_torch.runtime.stragglers` — per-worker compute-multiplier samplers
  (fixed slow set / lognormal / bursty Markov), pure in ``(seed, t)``;
* :mod:`repro_torch.runtime.elastic` — participation policies (``FullBarrier`` /
  ``DeadlineElastic``) that convert missed deadlines into the engine's
  runtime-mask contract.

Enable on an engine with ``HSGD(..., EngineConfig(runtime=RuntimeModel(
...)))``; the default ``runtime=None`` is bitwise-identical to the
runtime-free engine.
"""
from repro_torch.runtime.clock import (LinkModel, RuntimeLike, RuntimeModel,
                                 SimClock, default_links, make_runtime)
from repro_torch.runtime.elastic import (DeadlineElastic, FullBarrier,
                                   ParticipationPolicy, PolicyLike,
                                   make_policy)
from repro_torch.runtime.stragglers import (STRAGGLERS, BurstyStraggler,
                                      FixedSlowStraggler, LognormalStraggler,
                                      NoStraggler, StragglerLike,
                                      StragglerSampler, make_straggler,
                                      register_straggler)

__all__ = [
    "RuntimeModel", "RuntimeLike", "make_runtime", "SimClock", "LinkModel",
    "default_links",
    "ParticipationPolicy", "FullBarrier", "DeadlineElastic", "PolicyLike",
    "make_policy",
    "StragglerSampler", "NoStraggler", "FixedSlowStraggler",
    "LognormalStraggler", "BurstyStraggler", "STRAGGLERS", "StragglerLike",
    "make_straggler", "register_straggler",
]
