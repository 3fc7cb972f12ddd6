"""The Participation protocol (counterpart of ``repro.population``): one
surface for the topology's static event masks and the elastic runtime's
per-round masks.  The population sampler, ``SampledParticipation`` and the
population engine are ROADMAP A7c; only the protocol is ported here."""
from repro_torch.population.participation import (ComposedParticipation,
                                                  ElasticParticipation,
                                                  FullParticipation,
                                                  Participation,
                                                  StaticParticipation,
                                                  compose)

__all__ = [
    "Participation", "FullParticipation", "StaticParticipation",
    "ElasticParticipation", "ComposedParticipation", "compose",
]
