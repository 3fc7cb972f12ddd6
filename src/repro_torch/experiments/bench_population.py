"""Population-regime benchmark: virtual-client sampling cost against the
population size (counterpart of the JAX package's
``benchmarks/bench_population.py``, sim executor only).

A sampling round costs O(k) — k = topology.n active slots — however many
virtual clients stand behind it.  The sweep declares populations of 10^3
to 10^6 clients over a fixed k = 8 two-level topology and records, per
population size:

* host seconds per training step through the sampled loop (hydrate + G
  inner steps + fold-back) against the materialized n = k baseline engine
  on the same steps (their ratio is the population overhead), each read on
  the host clock after a ``synchronize``;
* the hydrated (k, ...) state bytes — asserted equal across the whole
  sweep and equal to the baseline's (69,984 bytes, as in the reference's
  ``BENCH_population.json``): peak state memory is bounded by k;
* the host-side draw time and the sampled-clients ledger size.

Also asserted: with ``cells == group_sizes`` (k == population) and
uniform weights, the sampled loop's server params are bit for bit row 0 of
the baseline engine's — fold-back IS the level-1 sync.  The reference's
mesh leg (exact mode bit for bit the sim) is ROADMAP A7d.

Writes ``build/BENCH_population_torch.json`` (the reference's
``BENCH_population.json`` is refused as an output name).

    PYTHONPATH=src python -m repro_torch.experiments.bench_population
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core import EngineConfig, HSGD, HierarchySpec, make_topology
from repro_torch.data import PopulationShards
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments.common import sync
from repro_torch.models import SimpleConfig, SimpleModel
from repro_torch.obs import SCHEMA_VERSION
from repro_torch.optim import sgd
from repro_torch.population import Population
from repro_torch.tree import tree_leaves

GS, PERIODS = (2, 4), (4, 2)     # k = 8 slots, G = 4 steps per round
K = 8
DIM, CLASSES, HIDDEN, BS = 24, 10, 32, 10
LR = 0.08
SEED = 11
BASELINE_STATE_BYTES = 69_984    # BENCH_population.json, "baseline"

# population sweep: per-level cell fanouts, 10^3 .. 10^6 virtual clients
SWEEP = {
    1_000: (10, 100),
    10_000: (100, 100),
    100_000: (100, 1_000),
    1_000_000: (1_000, 1_000),
}
OUT = "build/BENCH_population_torch.json"
REFERENCE_FILE = "BENCH_population.json"


def make_world():
    model = SimpleModel(SimpleConfig(kind="mlp", input_dim=DIM,
                                     hidden=HIDDEN, num_classes=CLASSES))
    shards = PopulationShards(population=max(SWEEP), num_classes=CLASSES,
                              dim=DIM, seed=SEED)
    return model, shards


def state_bytes(*trees) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for tree in trees for leaf in tree_leaves(tree))


def tree_equal(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def batch_fn(shards):
    return lambda ids, t: shards.batch(np.asarray(ids) % max(SWEEP), t, BS)


def _topology():
    return make_topology("uniform", spec=HierarchySpec(GS, PERIODS))


def _generator():
    return torch.Generator().manual_seed(0)


def bench_baseline(model, shards, rounds: int, dev: torch.device):
    """The materialized n = k engine on the same steps — the denominator of
    the population-overhead ratio, and the state-bytes reference."""
    eng = HSGD(model.loss, sgd(LR), _topology(), EngineConfig())
    st = eng.init(_generator(), model.init, device=dev)
    bf = batch_fn(shards)
    batch = lambda t: bf(np.arange(K), t)
    T = rounds * PERIODS[0]
    st, _ = eng.run_rounds(st, batch, T)       # warm-up: every round built
    sync(dev)
    t0 = time.perf_counter()
    st, _ = eng.run_rounds(st, batch, T)
    sync(dev)
    dt = time.perf_counter() - t0
    return {"time_per_step_s": dt / T,
            "state_bytes": state_bytes(st.params, st.opt_state)}, st


def bench_population(model, shards, cells, rounds: int, dev: torch.device):
    eng = HSGD(model.loss, sgd(LR), _topology(),
               EngineConfig(population=Population(cells=cells, seed=SEED)))
    popeng = eng.population_engine()
    server = eng.init_server(_generator(), model.init, device=dev)
    hydrated = popeng.hydrate(server)
    sb = state_bytes(hydrated.params, hydrated.opt_state)

    t0 = time.perf_counter()
    draws = [popeng.sampler.draw(r) for r in range(rounds)]
    draw_s = time.perf_counter() - t0
    assert all(d.client_ids.size == K for d in draws)

    bf = batch_fn(shards)
    T = rounds * PERIODS[0]
    server, _ = eng.run_sampled(server, bf, rounds)   # warm-up
    sync(dev)
    t0 = time.perf_counter()
    server, hist = eng.run_sampled(server, bf, rounds)
    sync(dev)
    dt = time.perf_counter() - t0
    return {"cells": list(cells),
            "time_per_step_s": dt / T,
            "draw_ms_per_round": 1e3 * draw_s / rounds,
            "state_bytes": sb,
            "unique_clients": hist[-1]["participation"]["unique"]}, server


def k_equals_population(model, shards, rounds: int,
                        dev: torch.device) -> bool:
    """Is the sampled loop with cells == group_sizes (k == population) bit
    for bit row 0 of the materialized engine's params, over 2 x rounds
    sampling rounds?"""
    eng = HSGD(model.loss, sgd(LR), _topology(),
               EngineConfig(population=Population(cells=GS, seed=SEED)))
    server = eng.init_server(_generator(), model.init, device=dev)
    server, _ = eng.run_sampled(server, batch_fn(shards), 2 * rounds)
    beng = HSGD(model.loss, sgd(LR), _topology(), EngineConfig())
    bst = beng.init(_generator(), model.init, device=dev)
    bf = batch_fn(shards)
    bst, _ = beng.run_rounds(bst, lambda t: bf(np.arange(K), t),
                             2 * rounds * PERIODS[0])
    row0 = {k: {n: x[0] for n, x in v.items()} for k, v in bst.params.items()}
    return tree_equal(row0, server.params)


def run(quick: bool = True, device: DeviceLike = "cuda") -> Dict:
    """The sweep and both proofs; the report, nothing asserted."""
    dev = resolve_device(device)
    model, shards = make_world()
    rounds = 2 if quick else 8
    base, _ = bench_baseline(model, shards, rounds, dev)
    report = {"schema_version": SCHEMA_VERSION, "k": K,
              "group_sizes": list(GS), "periods": list(PERIODS),
              "rounds": rounds, "backend": "sim", "device": str(dev),
              "baseline": base, "sweep": {}}
    for popsize, cells in SWEEP.items():
        print(f"... population {popsize} (cells {cells})", flush=True)
        rec, _ = bench_population(model, shards, cells, rounds, dev)
        rec["overhead_vs_baseline"] = \
            rec["time_per_step_s"] / base["time_per_step_s"]
        report["sweep"][str(popsize)] = rec
    sizes = {r["state_bytes"] for r in report["sweep"].values()}
    report["state_bytes_equal"] = \
        sizes == {base["state_bytes"]} == {BASELINE_STATE_BYTES}
    report["bitwise_k_eq_population"] = k_equals_population(
        model, shards, rounds, dev)
    return report


def main(quick: bool = True, out: str = OUT,
         device: DeviceLike = "cuda") -> Dict:
    """Run, assert both deterministic proofs and write ``out``."""
    if os.path.basename(out) == REFERENCE_FILE:
        raise ValueError(f"{REFERENCE_FILE} is the JAX package's record; "
                         f"write the port's elsewhere (default {OUT})")
    report = run(quick, device)
    # proof 1: peak state memory is bounded by k — identical across a
    # 1000x population sweep, and exactly the baseline's
    assert report["state_bytes_equal"], (
        {r["state_bytes"] for r in report["sweep"].values()},
        report["baseline"]["state_bytes"], BASELINE_STATE_BYTES)
    # proof 2: k == population with uniform weights is bit for bit the
    # materialized engine (fold-back IS the level-1 sync)
    assert report["bitwise_k_eq_population"], \
        "k == population sampled loop diverged from the materialized engine"
    parent = os.path.dirname(out)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}")
    print(json.dumps({"overhead_vs_baseline": {
        p: r["overhead_vs_baseline"] for p, r in report["sweep"].items()}}))
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="longer runs")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(quick=not args.full, out=args.out, device=args.device)
