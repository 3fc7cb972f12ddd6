"""The host's share of the probes' cost: steps/s of warmed probes-off and
probes-on engines on ``bench_obs``'s world, in alternating short windows.

``bench_obs`` times each arm once per repeat, from a fresh engine, so a
pair samples two moments of a shared host.  This measurement warms both
engines first and then alternates ``WINDOWS`` windows of ``STEPS`` steps
(off, on, off, on, ...), synchronizing the card at each window's ends, and
reports each arm's median steps/s and the median of the adjacent on/off
ratios.  At ``bench_obs``'s batch (512 a worker) the card bounds a step;
at batch 8 the host does, so the rate there is the host's cost of a step
and the ratio the host's share of the probes' cost.  Nothing is asserted.

    PYTHONPATH=src python -m repro_torch.experiments.obs_host [--device cuda]

Run by path with another tree's ``src`` on ``PYTHONPATH`` to measure that
tree's engine with the same procedure.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict

import torch

from repro_torch.core import EngineConfig, HSGD, make_topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments import bench_obs
from repro_torch.experiments.common import init_state, on_device, sync
from repro_torch.optim import sgd

WINDOWS, STEPS = 30, 16
BATCHES = (8, bench_obs.BATCH)


def measure(batch: int, spec, device: DeviceLike = "cuda",
            windows: int = WINDOWS, steps: int = STEPS) -> Dict:
    """Median steps/s of each arm over ``windows`` alternating windows of
    ``steps`` steps at ``batch`` a worker, and the median on/off ratio of
    adjacent windows."""
    dev = resolve_device(device)
    ds, model = bench_obs.make_obs_world(n_workers=spec.n_workers)
    arms = {}
    for name, metrics in (("off", None), ("on", "on")):
        topo = make_topology("uniform", spec=spec)
        eng = HSGD(model.loss, sgd(0.08), topo,
                   EngineConfig(executor="sim", metrics=metrics))
        state = init_state(eng, model, 0, dev, None)
        batches = [on_device(ds.batch(t, batch), dev)
                   for t in range(spec.G)]
        fn = (lambda t, b=batches: b[t % len(b)])
        state, _ = eng.run_rounds(state, fn, spec.G)   # builds every round
        arms[name] = {"eng": eng, "state": state, "fn": fn, "rates": []}
    for _ in range(windows):
        for arm in arms.values():
            sync(dev)
            t0 = time.perf_counter()
            arm["state"], _ = arm["eng"].run_rounds(arm["state"], arm["fn"],
                                                    steps)
            sync(dev)
            arm["rates"].append(steps / (time.perf_counter() - t0))
    off, on = arms["off"]["rates"], arms["on"]["rates"]
    return {"batch": batch, "windows": windows, "steps": steps,
            "off_steps_per_s": statistics.median(off),
            "on_steps_per_s": statistics.median(on),
            "on_over_off": statistics.median(a / b for a, b in zip(on, off))}


def main(device: DeviceLike = "cuda") -> Dict:
    out = {}
    for batch in BATCHES:
        for tname, spec in bench_obs.TOPOLOGIES.items():
            rec = measure(batch, spec, device)
            out[f"{tname}|{batch}"] = rec
            print(json.dumps({"topology": tname, **rec}), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
