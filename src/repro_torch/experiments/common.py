"""Shared experiment harness: live H-SGD training trajectories on the
paper's non-IID classification setup (CPU scale), plus the paper's
communication-time model (Table E.1).  Counterpart of the JAX package's
``benchmarks/common.py``.

Every function that starts an engine takes ``device`` and an optional
``init_params`` (the reference's params as numpy, loaded through
``params_from_numpy``); without them the model inits from
``torch.Generator().manual_seed(seed)``.  Trajectory records carry
``wall_s`` beside the reference's keys: the host seconds of training up to
that eval point, each reading taken after a ``synchronize``, evals
excluded.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import EngineConfig, HSGD, HierarchySpec, make_topology
from repro_torch.data import (FederatedDataset, label_shard_partition,
                              make_classification)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import SimpleConfig, SimpleModel, params_from_numpy
from repro_torch.optim import sgd
from repro_torch.tree import tree_map

# Table E.1 (ms per aggregation round) + measured 4 ms/iteration compute:
# the paper's communication model, not a time taken on any device here
COMM_MS = {
    "cnn": {"near": 0.29, "far": 4.53},
    "vgg11": {"near": 27.81, "far": 291.82},
}
COMPUTE_MS_PER_ITER = 4.0


def make_world(n_workers: int = 8, num_classes: int = 8, dim: int = 24,
               seed: int = 3):
    x, y = make_classification(seed, num_classes=num_classes, dim=dim,
                               per_class=80, spread=1.5)
    parts = label_shard_partition(
        y, [[j % num_classes] for j in range(n_workers)],
        n_workers=n_workers)
    ds = FederatedDataset(x, y, parts).require_workers(n_workers)
    model = SimpleModel(SimpleConfig(kind="mlp", input_dim=dim, hidden=32,
                                     num_classes=num_classes))
    return ds, model


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def init_state(eng: HSGD, model, seed: int, dev: torch.device,
               init_params=None):
    """The engine's state from ``init_params`` (numpy, the reference's
    layout) or from ``model.init`` on a CPU generator seeded ``seed``."""
    if init_params is not None:
        return eng.init_from_params(params_from_numpy(init_params, dev),
                                    device=dev)
    return eng.init(torch.Generator().manual_seed(seed), model.init,
                    device=dev)


def on_device(batch, dev: torch.device):
    return tree_map(lambda v: torch.as_tensor(v).to(dev), batch)


def trajectory(ds, model, topology, T: int, lr: float = 0.08, seed: int = 0,
               bs: int = 10, eval_every: int = 8,
               use_rounds: bool = False, backend: str = "sim",
               comms=None, device: DeviceLike = "cuda",
               init_params=None) -> List[Dict]:
    """use_rounds=True runs the schedule-compiled ``run_rounds`` executor
    (same trajectory — tested — fewer dispatches); eval points then land on
    the round boundaries hit by ``eval_every``.  ``backend`` picks the
    executor ("sim" | "mesh"); ``comms`` a communication plan."""
    dev = resolve_device(device)
    if isinstance(topology, HierarchySpec):
        topology = make_topology(topology)
    eng = HSGD(model.loss, sgd(lr), topology,
               EngineConfig(executor=backend, comms=comms))
    st = init_state(eng, model, seed, dev, init_params)
    gb = on_device(ds.global_batch(640), dev)
    clock = {"wall": 0.0, "since": 0.0}

    def evaluate(state):
        sync(dev)
        clock["wall"] += time.perf_counter() - clock["since"]
        wbar = eng.mean_params(state)
        rec = {"loss": float(model.loss(wbar, gb)[0]),
               "acc": float(model.accuracy(wbar, gb)),
               "wall_s": clock["wall"]}
        clock["since"] = time.perf_counter()
        return rec

    batch_fn = lambda t: ds.batch(t, bs)
    clock["since"] = time.perf_counter()
    if use_rounds:
        st, hist = eng.run_rounds(
            st, batch_fn, T, eval_every=eval_every,
            eval_fn=lambda state, t: evaluate(state))
        return [{"step": rec["t"], "loss": rec["loss"], "acc": rec["acc"],
                 "wall_s": rec["wall_s"]}
                for rec in hist if "acc" in rec]
    hist = []
    for t in range(T):
        st, _ = eng.step(st, batch_fn(t))
        if (t + 1) % eval_every == 0 or t + 1 == T:
            hist.append({"step": t + 1, **evaluate(st)})
    return hist


def steps_per_sec(ds, model, topology, T: int = 256, lr: float = 0.08,
                  bs: int = 10, use_rounds: bool = False,
                  warmup: int = 32, backend: str = "sim",
                  comms=None, device: DeviceLike = "cuda",
                  init_params=None, metrics=None) -> float:
    """Wall-clock throughput of the trajectory harness (no evals): the
    per-step dispatcher vs the schedule-compiled round executor, host clock
    after a ``synchronize`` on both ends, with an optional comms plan and
    metrics plan (``metrics="on"`` for the probes' overhead contract)."""
    dev = resolve_device(device)
    if isinstance(topology, HierarchySpec):
        topology = make_topology(topology)
    eng = HSGD(model.loss, sgd(lr), topology,
               EngineConfig(executor=backend, comms=comms, metrics=metrics))
    st = init_state(eng, model, 0, dev, init_params)
    # warmup must span >= one full global period so EVERY step/round
    # signature is built before the timed region, and end on a period
    # boundary so the timed region is phase-aligned with the cached rounds
    G = topology.periods[0]
    warmup = -(-max(warmup, G) // G) * G
    batches = [on_device(ds.batch(t, bs), dev) for t in range(T + warmup)]
    batch_fn = lambda t: batches[t]

    def go(state, t0, steps):
        if use_rounds:
            state, _ = eng.run_rounds(state, batch_fn, steps)
        else:
            for t in range(t0, t0 + steps):
                state, _ = eng.step(state, batch_fn(t))
        return state

    st = go(st, 0, warmup)
    sync(dev)
    t0 = time.perf_counter()
    st = go(st, warmup, T)
    sync(dev)
    return T / (time.perf_counter() - t0)


def mean_trajectories(ds, model, topo_fn, T, seeds=(0, 1, 2), **kw):
    runs = [trajectory(ds, model, topo_fn(), T, seed=s, **kw) for s in seeds]
    out = []
    for recs in zip(*runs):
        out.append({"step": recs[0]["step"],
                    "loss": float(np.mean([r["loss"] for r in recs])),
                    "acc": float(np.mean([r["acc"] for r in recs])),
                    "wall_s": float(np.mean([r["wall_s"] for r in recs]))})
    return out


def comm_time_ms(spec: HierarchySpec, steps: int, model_kind: str = "cnn",
                 single_level_is_far: bool = True) -> float:
    """Paper communication model: every level-M (innermost) aggregation costs
    a near round; every level-1 (global) aggregation a far round; single-level
    local SGD always pays the far cost (workers -> global server)."""
    c = COMM_MS[model_kind]
    counts = spec.sync_counts(steps)
    total = steps * COMPUTE_MS_PER_ITER
    if spec.num_levels == 1:
        return total + counts[0] * (c["far"] if single_level_is_far
                                    else c["near"])
    return total + counts[0] * c["far"] + sum(counts[1:]) * c["near"]


def first_at_target(hist: List[Dict], target_acc: float) -> Optional[Dict]:
    """The first eval record whose accuracy reaches ``target_acc``."""
    return next((rec for rec in hist if rec["acc"] >= target_acc), None)


def time_to_target(hist: List[Dict], spec: HierarchySpec, target_acc: float,
                   model_kind: str = "cnn") -> Optional[float]:
    rec = first_at_target(hist, target_acc)
    return None if rec is None else comm_time_ms(spec, rec["step"],
                                                 model_kind)
