"""The Participation protocol: ONE surface for "who takes part" (PyTorch
port's copy of ``repro.population.participation``, numpy only).

The engine grew three participation-like surfaces, each with its own shape:

* ``Topology.participants(event)`` — *static* per-event participation (a
  grouped topology's partial-group events);
* the runtime's elastic masks — *dynamic* per-round participation
  (``SimClock.sync`` returns who made the barrier);
* caller-supplied masks on :meth:`HSGD.step`.

This module names the protocol they all implement — three hooks at three
temporal scopes — and adapts each existing surface onto it;
``HSGD.run_rounds`` consults the composed protocol object instead of
reaching into the clock directly.  The population sampler's adapter
(``SampledParticipation``) and the population engine that pins it per
round are ROADMAP A7c, not ported yet.

Hooks
-----
``event_mask(event)``
    Static: which worker slots an event's aggregate *replaces*, fixed per
    event kind (compiled into the jitted round body — this is what
    ``Topology.participants`` has always been).
``round_mask(event)``
    Dynamic: which slots made THIS round's barrier.  A consuming call —
    invoked at most once per executed sync (the elastic adapter advances
    its clock) — whose result routes the round through the masked executor
    variant (drop semantics: masked slots neither contribute to nor receive
    the aggregate).
``draw(round_index)``
    Population: which *virtual clients* occupy the slots this round, pure
    in ``(seed, round)``; None means the slots ARE the workers (the
    materialized regime, the only one ported yet).
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Optional, Sequence

import numpy as np



class Participation(abc.ABC):
    """Protocol base: every hook defaults to "no restriction" so adapters
    override only the scope they own."""

    def event_mask(self, event) -> Optional[np.ndarray]:
        return None

    def round_mask(self, event) -> Optional[np.ndarray]:
        return None

    def draw(self, round_index: int) -> Optional[Any]:
        return None

    def describe(self) -> Dict:
        return {"kind": type(self).__name__}


class FullParticipation(Participation):
    """Everyone, always — the protocol's identity element."""


class StaticParticipation(Participation):
    """Adapter over ``Topology.participants(event)`` (the static scope)."""

    def __init__(self, topology):
        self.topology = topology

    def event_mask(self, event) -> Optional[np.ndarray]:
        return self.topology.participants(event)

    def describe(self) -> Dict:
        return {"kind": "static", "topology": type(self.topology).__name__}


class ElasticParticipation(Participation):
    """Adapter over a live :class:`~repro_torch.runtime.SimClock`: ``round_mask``
    closes the barrier (``clock.sync`` — consuming, advances simulated
    time) and returns who the deadline policy admitted."""

    def __init__(self, clock):
        self.clock = clock

    def round_mask(self, event) -> Optional[np.ndarray]:
        return self.clock.sync(event)

    def describe(self) -> Dict:
        return {"kind": "elastic", "policy": repr(self.clock.model.policy)}


class ComposedParticipation(Participation):
    """AND of masks, first non-None draw.  ``round_mask`` calls every
    member exactly once (members may consume — the elastic adapter does)."""

    def __init__(self, parts: Sequence[Participation]):
        self.parts = tuple(parts)

    @staticmethod
    def _and(masks) -> Optional[np.ndarray]:
        masks = [m for m in masks if m is not None]
        if not masks:
            return None
        out = np.asarray(masks[0], bool).copy()
        for m in masks[1:]:
            out &= np.asarray(m, bool)
        return out

    def event_mask(self, event) -> Optional[np.ndarray]:
        return self._and(p.event_mask(event) for p in self.parts)

    def round_mask(self, event) -> Optional[np.ndarray]:
        return self._and([p.round_mask(event) for p in self.parts])

    def draw(self, round_index: int) -> Optional[Any]:
        for p in self.parts:
            d = p.draw(round_index)
            if d is not None:
                return d
        return None

    def describe(self) -> Dict:
        return {"kind": "composed",
                "parts": [p.describe() for p in self.parts]}


def compose(*parts: Optional[Participation]) -> Participation:
    """Compose, dropping Nones; 0 parts → FullParticipation, 1 part → it."""
    live = [p for p in parts if p is not None]
    if not live:
        return FullParticipation()
    if len(live) == 1:
        return live[0]
    return ComposedParticipation(live)
