"""Observability overhead benchmark (counterpart of the JAX package's
``benchmarks/bench_obs.py``): the timed leg on the sim executor, and the
static leg on the sim and the mesh.

The in-round divergence and grad-norm probes (``repro_torch.obs``) promise
to be cheap enough to leave on.  This benchmark times the schedule-compiled
round executor with ``metrics="on"`` against ``metrics=None`` on a
two-level and a three-level hierarchy, both back to back in every repeat,
and records both rates and their ratio.  Asserted, as the reference
asserts it: probes-on reaches at least ``MIN_RATIO`` of probes-off
steps/s on the best SAME-REPEAT pairing (each pairing samples the same
machine state; the best one discards repeats that landed in a slow phase
of a shared host).  The world is the reference's: an MLP 64-256-8, batch
``BATCH`` per worker, inner syncs every 8 steps.

The static leg (:func:`probe_op_leg`, the reference's) audits the
metrics-on engine (:mod:`repro_torch.analysis`) against its metrics-off
twin and asserts the probe's contract: zero extra host reads and
transfers per round body, and at most ``Metrics.op_budget`` extra
aggregation ops.  It runs on the sim executor in this process and on the
mesh executor in one launch of eight ``gloo`` ranks per topology.

Writes ``build/BENCH_obs_torch.json`` (the reference's ``BENCH_obs.json``
is its own record and is refused as an output name).

    PYTHONPATH=src python -m repro_torch.experiments.bench_obs [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import torch

from repro_torch.core import EngineConfig, HSGD, HierarchySpec, make_topology
from repro_torch.data import (FederatedDataset, label_shard_partition,
                              make_classification)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments.common import steps_per_sec
from repro_torch.models import SimpleConfig, SimpleModel
from repro_torch.obs import SCHEMA_VERSION
from repro_torch.optim import sgd

TOPOLOGIES = {
    "two_level": HierarchySpec((2, 4), (32, 8)),
    "three_level": HierarchySpec((2, 2, 2), (32, 16, 8)),
}

# every repeat times off/on back to back; each variant keeps its per-rep
# rate so the assertion can pick the best SAME-REP ratio (see module doc)
REPEATS = 3
MIN_RATIO = 0.95
# the contract is stated for training steps with real compute: a wide MLP
# and a batch per worker big enough that the grad step dominates the
# probes; the inner sync every 8 steps amortizes the divergence row
BATCH = 512
DIM, HIDDEN, CLASSES = 64, 256, 8
# the static leg audits both executors (the mesh as eight gloo ranks)
BACKENDS = ("sim", "mesh")
OUT = "build/BENCH_obs_torch.json"
REFERENCE_FILE = "BENCH_obs.json"


def make_obs_world(n_workers: int = 8, seed: int = 3):
    x, y = make_classification(seed, num_classes=CLASSES, dim=DIM,
                               per_class=160, spread=1.5)
    parts = label_shard_partition(
        y, [[j % CLASSES] for j in range(n_workers)])
    ds = FederatedDataset(x, y, parts)
    model = SimpleModel(SimpleConfig(kind="mlp", input_dim=DIM,
                                     hidden=HIDDEN, num_classes=CLASSES))
    return ds, model


def probe_block(spec: HierarchySpec, backend: str, device: str) -> Dict:
    """The ``probes`` block of the metrics-on engine's audit on
    ``backend``, its contract asserted (see :func:`probe_op_leg`)."""
    topo = make_topology("uniform", spec=spec)
    model = SimpleModel(SimpleConfig(kind="mlp", input_dim=16, hidden=8,
                                     num_classes=4))
    eng = HSGD(model.loss, sgd(0.08), topo,
               EngineConfig(executor=backend, metrics="on"))
    state = eng.init(torch.Generator().manual_seed(0), model.init,
                     device=device)
    n = topo.n

    def batch_fn(t):
        x = torch.randn((n, 4, 16), generator=torch.Generator()
                        .manual_seed(t))
        return {"x": x, "y": torch.zeros((n, 4), dtype=torch.int32)}

    report = eng.audit(state, batch_fn=batch_fn, run=False)
    probes = report.probes
    assert probes is not None
    for key, d in probes["rounds"].items():
        assert d["extra_callbacks"] == 0 and d["extra_transfers"] == 0, \
            (key, d)
        assert d["extra_ops"] <= probes["budget"], (key, d, probes["budget"])
    return probes


def _probes_rank(rank: int, spec: HierarchySpec, device: str):
    probes = probe_block(spec, "mesh", device)
    return probes if rank == 0 else None


def probe_op_leg(spec: HierarchySpec, backend: str,
                 device: DeviceLike = "cuda") -> Dict:
    """Static leg: audit the metrics-on engine and return its ``probes``
    block (extra ops / host reads / transfers per round vs the
    metrics-off twin), asserting the op budget and the zero-host-cost
    contract.  ``backend="mesh"`` runs it on one ``gloo`` rank per
    worker."""
    dev = str(resolve_device(device))
    if backend == "mesh":
        from repro_torch.launch.mesh import launch
        return launch(_probes_rank, spec.n_workers, backend="gloo",
                      device=dev, args=(spec, dev))
    return probe_block(spec, backend, dev)


def bench_topology(ds, model, spec: HierarchySpec, T: int,
                   device: DeviceLike = "cuda",
                   backends=BACKENDS) -> Dict:
    """Off/on steps/s of ``REPEATS`` same-repeat pairs on the sim
    executor, unrounded, with the per-pair ratios, and the static leg's
    ``probes`` block per audited backend."""
    runs = {"off": [], "on": []}
    for rep in range(REPEATS):
        for name, metrics in (("off", None), ("on", "on")):
            topo = make_topology("uniform", spec=spec)
            runs[name].append(steps_per_sec(
                ds, model, topo, T=T, bs=BATCH, use_rounds=True,
                warmup=spec.G, backend="sim", metrics=metrics,
                device=device))
        print(f"... rep {rep}: off={runs['off'][-1]!r} "
              f"on={runs['on'][-1]!r} steps/s", flush=True)
    pairs = [on / off for on, off in zip(runs["on"], runs["off"])]
    return {
        "off": {"steps_per_sec_best": max(runs["off"]),
                "steps_per_sec_all": runs["off"]},
        "on": {"steps_per_sec_best": max(runs["on"]),
               "steps_per_sec_all": runs["on"]},
        "ratio_best_pair": max(pairs),
        "ratio_all": pairs,
        "probes": {b: probe_op_leg(spec, b, device) for b in backends},
    }


def run(quick: bool = True, device: DeviceLike = "cuda",
        backends=BACKENDS) -> Dict:
    """Both legs over both topologies: the report, with the static leg's
    contract asserted (the timed leg's bound is :func:`main`'s)."""
    dev = resolve_device(device)
    ds, model = make_obs_world(n_workers=8)
    T = 64 if quick else 256
    report = {"schema_version": SCHEMA_VERSION, "steps": T,
              "repeats": REPEATS, "timed_backend": "sim",
              "audited_backends": list(backends),
              "device": str(dev), "min_ratio": MIN_RATIO, "topologies": {}}
    for tname, spec in TOPOLOGIES.items():
        print(f"... {tname} (timed: sim on {dev}; audited: "
              f"{'+'.join(backends)})", flush=True)
        report["topologies"][tname] = bench_topology(ds, model, spec, T, dev,
                                                     backends)
    return report


def main(quick: bool = True, out: str = OUT,
         device: DeviceLike = "cuda") -> Dict:
    """Run, write ``out`` and assert the overhead contract per topology."""
    if os.path.basename(out) == REFERENCE_FILE:
        raise ValueError(f"{REFERENCE_FILE} is the JAX package's record; "
                         f"write the port's elsewhere (default {OUT})")
    report = run(quick, device)
    parent = os.path.dirname(out)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}")
    summary = {t: row["ratio_best_pair"]
               for t, row in report["topologies"].items()}
    print(json.dumps({"probe_overhead_ratio": summary}))
    for tname, row in report["topologies"].items():
        # the overhead contract: probes-on within 5% of probes-off on the
        # best same-rep pairing
        assert row["ratio_best_pair"] >= MIN_RATIO, (tname, row)
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="longer runs")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(quick=not args.full, out=args.out, device=args.device)
