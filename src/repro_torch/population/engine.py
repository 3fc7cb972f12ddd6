"""Hydrate → run → fold-back: the population-regime round loop (PyTorch
counterpart of ``repro.population.engine``).

A *sampling round* is one global period G of the bound topology:

1. ``sampler.draw(r)`` picks the k = topology.n virtual clients (pure in
   ``(seed, r)`` — see :mod:`repro_torch.population.sampler`);
2. **hydrate**: the server model is copied into a fresh ``(k, ...)``
   engine state (virtual clients are stateless between rounds — error
   feedback and probe buffers reset; optimizer state, including schedule
   counters, carries over from the server so trajectories line up with the
   materialized engine);
3. the UNCHANGED round executor runs the G steps — on an *inner* engine
   whose topology is the user's with level-1 events removed, so sub-global
   levels sync exactly as declared while the global aggregation is
   deferred to the fold-back;
4. **fold-back**: the server model absorbs the slot results with
   dataset-size × staleness weights.  ``dense`` takes the weighted mean of
   slot params through the topology's own level-1 ``aggregate`` (with
   uniform weights this is bit for bit the materialized engine's global
   sync), and ``nonzero`` applies the per-entry nonzero-mask weighted mean
   to slot *deltas* (an entry only a sparse codec's selected coordinates
   touched averages over the slots that moved it, and an entry nobody
   moved keeps the server value through
   :func:`~repro_torch.core.aggregators.denominator_floor`, never NaN).

Peak state memory is bounded by k: the population exists only as the
sampler's arithmetic and the (sparsely grown) participation ledger.  On
the mesh executor the inner engine runs one slot per rank (a twin of the
outer executor, on the same mesh); the draws are host numpy, the same on
every rank, and the fold-back first gathers the (k, ...) slots to every
rank, which then folds them in the sim's reduction order: the server
model is the same on every rank, and in exact mode the sim's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.aggregators import denominator_floor
from repro_torch.core.hierarchy import HierarchySpec
from repro_torch.core.topology import SyncEvent, UniformTopology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.population.participation import SampledParticipation
from repro_torch.population.sampler import (Draw, HierarchicalSampler,
                                            Population, default_client_sizes)
from repro_torch.tree import tree_leaves, tree_map


class _SubGlobalTopology(UniformTopology):
    """The bound topology with level-1 events removed: within a sampling
    round the sub-global levels sync exactly as declared, and the global
    aggregation happens at the fold-back instead — on the SAME schedule
    positions the materialized engine would fire level 1 (steps that are
    multiples of G fire nothing in the round body)."""

    def event_at(self, t: int):
        ev = super().event_at(t)
        return None if ev is not None and ev.level == 1 else ev


@dataclasses.dataclass
class ParticipationLedger:
    """Sparse host-side record of who has participated — grows with the
    number of *sampled* clients, never with the population."""
    last_round: Dict[int, int] = dataclasses.field(default_factory=dict)
    counts: Dict[int, int] = dataclasses.field(default_factory=dict)

    def note(self, round_index: int, client_ids: np.ndarray) -> Dict:
        ids = [int(c) for c in client_ids if c >= 0]
        reseen = sum(1 for c in ids if c in self.counts)
        for c in ids:
            self.counts[c] = self.counts.get(c, 0) + 1
            self.last_round[c] = int(round_index)
        return {"reseen": reseen, "unique": len(self.counts)}


@dataclasses.dataclass
class ServerState:
    """The population regime's server model: ONE replica (no worker axis),
    plus the sampling-round counter and the participation ledger."""
    params: Any
    opt_state: Any
    round: int = 0
    ledger: ParticipationLedger = dataclasses.field(
        default_factory=ParticipationLedger)


class PopulationEngine:
    """Binds a plan (:class:`~repro_torch.core.hsgd.HSGD` with
    ``config.population`` set) to the hydrate/run/fold-back loop.  Built
    lazily by :meth:`HSGD.run_sampled`."""

    def __init__(self, plan):
        pop: Population = plan.population
        assert pop is not None, "plan has no population bound"
        topo = plan.topology
        if not isinstance(topo, UniformTopology):
            raise TypeError(
                f"the population regime needs a UniformTopology over the "
                f"k active slots (got {type(topo).__name__}); express "
                f"grouped structure in the population cells instead")
        gs, periods = topo.spec.group_sizes, topo.spec.periods
        self.plan = plan
        self.population = pop
        self.sampler = HierarchicalSampler(pop, gs)
        self.round_steps = int(periods[0])  # G: one sampling round
        # inner topology: the user's with level-1 events REMOVED (not a
        # stretched period, which would let level 2 fire at the global
        # boundary and pre-average the rows) — fold-back IS level 1
        from repro_torch.core.hsgd import HSGD, EngineConfig
        inner_topo = _SubGlobalTopology(HierarchySpec(gs, periods),
                                        aggregator=topo.aggregator)
        self.inner = HSGD(
            plan.loss_fn, plan.optimizer, inner_topo,
            EngineConfig(executor=plan.executor.twin(),
                         comms=plan.comms, runtime=plan.runtime,
                         metrics=plan.metrics,
                         aggregate_opt_state=plan.aggregate_opt_state,
                         accum_steps=plan.accum_steps))
        self._fold_cache: Dict[Tuple, Callable] = {}

    # -- mode resolution -----------------------------------------------------
    @property
    def fold_mode(self) -> str:
        mode = self.population.fold
        if mode != "auto":
            return mode
        codec = getattr(self.plan.comms, "codec", None)
        return "nonzero" if getattr(codec, "name", "") == "topk" else "dense"

    # -- hydrate -------------------------------------------------------------
    def init_server(self, generator: torch.Generator, model_init: Callable,
                    *, device: DeviceLike = "cuda") -> ServerState:
        """``model_init(generator, device=device)`` as the server model."""
        dev = resolve_device(device)
        return self.init_server_from_params(
            model_init(generator, device=dev), device=dev)

    def init_server_from_params(self, params, *,
                                device: DeviceLike = "cuda") -> ServerState:
        dev = resolve_device(device)
        params0 = tree_map(lambda x: torch.as_tensor(x).to(dev), params)
        return ServerState(params=params0,
                           opt_state=self.plan.optimizer.init(params0))

    def hydrate(self, server: ServerState):
        """Copy the server model into a fresh placed (k, ...) state.  Every
        slot gets its own storage (``expand(...).clone()``): a bare
        ``expand`` would alias the k rows to one."""
        from repro_torch.core.hsgd import HSGDState, _replicate
        eng, k = self.inner, self.inner.topology.n
        params = _replicate(server.params, k)
        dev = tree_leaves(params)[0].device
        state = HSGDState(
            params, _replicate(server.opt_state, k), 0,
            eng.comms.init_state(params) if eng.comms else None,
            eng.metrics.init_buffer(eng.topology, dev) if eng.metrics
            else None)
        return eng.executor.place(state)

    # -- fold-back -----------------------------------------------------------
    def _fold_fn(self, mode: str, weighted: bool) -> Callable:
        key = (mode, weighted)
        if key in self._fold_cache:
            return self._fold_cache[key]
        topo = self.plan.topology
        acc = topo.aggregator.accum_dtype
        ev = SyncEvent(level=1)

        def dense(tree, w):
            # EXACTLY the engine's level-1 aggregate (same reshape-mean,
            # same accumulation dtype — that is what makes the uniform case
            # bitwise with the materialized global sync), then one row
            return tree_map(lambda x: x[0].clone(),
                            topo.aggregate(tree, ev, mask=w))

        def fold_leaf_nonzero(s, p, w):
            d = p.to(acc) - s.to(acc)[None]
            m = (d != 0).to(acc)
            if w is not None:
                m = m * w.to(acc).reshape((-1,) + (1,) * (p.ndim - 1))
            num = (d * m).sum(0, dtype=acc)
            den = torch.maximum(m.sum(0, dtype=acc),
                                denominator_floor(acc, p.device))
            return (s.to(acc) + num / den).to(s.dtype)

        def fold(server_params, server_opt, params, opt_state, w):
            if mode == "dense":
                new_params = dense(params, w)
            else:
                new_params = tree_map(
                    lambda s, p: fold_leaf_nonzero(s, p, w),
                    server_params, params)
            # moments fold dense (they ride the level-1 sync the same way in
            # the materialized engine); counters are identical across slots
            new_opt = {
                name: (dense(v, w)
                       if name in ("m", "v") and self.plan.aggregate_opt_state
                       else tree_map(lambda p: p[0].clone(), v))
                for name, v in opt_state.items()}
            return new_params, new_opt

        self._fold_cache[key] = fold
        return fold

    def fold_back(self, server: ServerState, state,
                  weights: Optional[np.ndarray]) -> ServerState:
        """Fold the round's (k, ...) results into the server model.  An
        all-zero weight vector (every slot empty) keeps the server exactly
        — the zero-denominator guard's host-side twin."""
        if weights is not None and not np.any(weights > 0):
            return server
        # the (k, ...) slots on this process: all of them under the sim, and
        # every rank's gathered under the mesh
        gather = self.inner.executor.gather
        params, opt_state = gather(state.params), gather(state.opt_state)
        dev = tree_leaves(params)[0].device
        w = None if weights is None else \
            torch.as_tensor(weights, dtype=torch.float32, device=dev)
        new_params, new_opt = self._fold_fn(self.fold_mode, w is not None)(
            server.params, server.opt_state, params, opt_state, w)
        return dataclasses.replace(server, params=new_params,
                                   opt_state=new_opt)

    # -- weights -------------------------------------------------------------
    def round_weights(self, draw: Draw,
                      sizes: Optional[Callable[[int], float]] = None
                      ) -> Tuple[Optional[np.ndarray], Dict]:
        """Fold-back weights = dataset size × staleness × availability.
        Returns None (the bitwise plain-mean path) when every factor is
        trivially uniform."""
        pop = self.population
        active = draw.active
        w = active.astype(np.float64)
        if pop.weighting == "size":
            law = sizes if sizes is not None \
                else default_client_sizes(pop.seed)
            w = w * np.array([law(int(c)) for c in draw.client_ids])
        stale = np.zeros(len(w), np.int64)
        clock = self.inner._last_clock
        if clock is not None and pop.staleness_decay < 1.0 \
                and clock.last_admitted:
            # slots the elastic policy cut from the round's outermost fired
            # barrier carry params one admitted sync behind
            lvl = min(clock.last_admitted)
            stale = (~clock.last_admitted[lvl]).astype(np.int64)
            w = w * (pop.staleness_decay ** stale)
        meta = {"active": int(active.sum()),
                "stale_slots": int((stale > 0).sum())}
        uniform = pop.weighting == "uniform" and active.all() \
            and not (stale > 0).any()
        return (None if uniform else w), meta

    # -- the loop ------------------------------------------------------------
    def run(self, server: ServerState, batch_fn: Callable[[np.ndarray, int],
                                                          Any],
            rounds: int, *, sizes: Optional[Callable[[int], float]] = None,
            eval_every: int = 0,
            eval_fn: Optional[Callable[[ServerState, int], Dict]] = None
            ) -> Tuple[ServerState, List[Dict]]:
        """``batch_fn(client_ids, t)`` -> a batch with leading axis k for
        global step t (k-aligned with ``client_ids``; ids are -1 for empty
        slots).  Returns one history record per sampling round."""
        history: List[Dict] = []
        G = self.round_steps
        for _ in range(int(rounds)):
            r = server.round
            draw = self.sampler.draw(r)
            part = SampledParticipation(self.population,
                                        self.plan.topology.spec.group_sizes,
                                        round_index=r)
            state = self.hydrate(server)
            state, inner_hist = self.inner.run_rounds(
                state, lambda t: batch_fn(draw.client_ids, r * G + t), G,
                participation=part)
            weights, wmeta = self.round_weights(draw, sizes)
            server = self.fold_back(server, state, weights)
            server.round = r + 1
            ledger = server.ledger.note(r, draw.client_ids)
            rec: Dict = {"round": r + 1, "t": (r + 1) * G}
            last = inner_hist[-1] if inner_hist else {}
            rec.update({k: v for k, v in last.items()
                        if k != "t" and isinstance(v, (int, float))})
            # wire_bytes/dropped are per-step channels, and the round's final
            # step is the dropped level-1 slot (0 bytes) — report round totals
            for key in ("wire_bytes", "dropped"):
                if any(key in h for h in inner_hist):
                    rec[key] = sum(h.get(key, 0) for h in inner_hist)
            rec["participation"] = {
                "k": draw.k, "population": self.population.size,
                "cells": draw.num_cells(), **wmeta, **ledger}
            if eval_fn is not None and eval_every \
                    and (server.round % eval_every == 0
                         or server.round == rounds):
                rec.update(eval_fn(server, server.round))
            history.append(rec)
        if self.plan.metrics is not None:
            from repro_torch.obs import validate_record
            for rec in history:
                errs = validate_record(rec)
                if errs:
                    raise ValueError(
                        "metrics-bus violations in run_sampled history at "
                        f"round={rec.get('round')}: " + "; ".join(errs))
        return server, history

    # -- analysis ------------------------------------------------------------
    def audit(self, server: ServerState, batch_fn=None, **kwargs):
        """Audit the sampled round body (the inner engine over one sampling
        round): R1–R6 on exactly the program :meth:`run` dispatches, with
        the clients of round ``server.round``'s draw hydrated."""
        wrapped = None
        if batch_fn is not None:
            draw = self.sampler.draw(server.round)
            wrapped = lambda t: batch_fn(draw.client_ids, t)
        kwargs.setdefault("T", self.round_steps)
        return self.inner.audit(self.hydrate(server), wrapped, **kwargs)
