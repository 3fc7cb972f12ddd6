"""Population-scale virtual-client sampling behind the Participation
protocol (counterpart of ``repro.population``).

The materialized engine holds every worker in the ``(n, ...)`` state; this
package scales the *declared* world past memory: a :class:`Population` of
``prod(cells)`` virtual clients, a hierarchical per-round sampler pure in
``(seed, round)``, hydrate/fold-back between a single-replica
:class:`ServerState` and the existing ``(k, ...)`` engine, and the
:class:`Participation` protocol unifying the static topology masks, the
elastic runtime masks, and the sampler.  Entry point:
``HSGD(..., EngineConfig(population=...))`` then :meth:`HSGD.run_sampled`.
"""
from repro_torch.population.engine import (ParticipationLedger,
                                           PopulationEngine, ServerState)
from repro_torch.population.participation import (ComposedParticipation,
                                                  ElasticParticipation,
                                                  FullParticipation,
                                                  Participation,
                                                  SampledParticipation,
                                                  StaticParticipation,
                                                  compose)
from repro_torch.population.sampler import (Draw, HierarchicalSampler,
                                            Population, PopulationLike,
                                            default_client_sizes,
                                            make_population)

__all__ = [
    "Population", "PopulationLike", "make_population", "Draw",
    "HierarchicalSampler", "default_client_sizes",
    "Participation", "FullParticipation", "StaticParticipation",
    "ElasticParticipation", "SampledParticipation", "ComposedParticipation",
    "compose",
    "PopulationEngine", "ServerState", "ParticipationLedger",
]
