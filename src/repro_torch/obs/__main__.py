"""``python -m repro_torch.obs`` — a self-contained observability demo run
(the PyTorch counterpart of ``python -m repro.obs``).

Trains a tiny synthetic H-SGD world (SimpleModel MLP, random batches drawn
with numpy from a seed — no dataset or benchmark harness imports) with the
in-round probes on and, by default, a simulated runtime clock, then
exports the run as a Chrome-trace-event / Perfetto JSON (load it at
https://ui.perfetto.dev or chrome://tracing) and prints one summary line
per sync event with the live eq. (10) partition.  The trace is validated
against the trace-event schema (:func:`repro_torch.obs.validate_trace`)
before it is written, so a malformed exporter fails the run, not the
viewer.

    PYTHONPATH=src python -m repro_torch.obs --out build/trace.json
    PYTHONPATH=src python -m repro_torch.obs --levels 2 --device cpu

It runs on ``cuda`` unless ``--device cpu`` is given, and refuses a
missing card.  The run is on the sim executor; the mesh executor's probe
(``Metrics.mesh_row_fn``) needs one process per worker
(``repro_torch.launch.mesh.launch``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch.core.hsgd import HSGD, EngineConfig
from repro_torch.core.topology import HierarchySpec, make_topology
from repro_torch.device import resolve_device
from repro_torch.models.simple import SimpleConfig, SimpleModel
from repro_torch.obs import TraceRecorder, validate_trace
from repro_torch.optim.optimizers import sgd

SPECS = {
    2: HierarchySpec((2, 4), (8, 4)),
    3: HierarchySpec((2, 2, 2), (8, 4, 2)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="probes-on demo run with Perfetto trace export")
    ap.add_argument("--out", default="build/obs_trace.json",
                    help="trace JSON path (default: build/obs_trace.json)")
    ap.add_argument("--steps", type=int, default=16,
                    help="training steps (default: 16 = two global periods)")
    ap.add_argument("--levels", type=int, choices=(2, 3), default=3,
                    help="hierarchy depth (default: 3)")
    ap.add_argument("--runtime", default="0.004",
                    help="simulated seconds per local step for the runtime "
                         "clock ('' disables it; spans then use step-index "
                         "time)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial params and the batches")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = SPECS[args.levels]
    topo = make_topology("uniform", spec=spec)
    model = SimpleModel(SimpleConfig(kind="mlp", input_dim=16, hidden=16,
                                     num_classes=4))
    runtime = None
    if args.runtime:
        from repro_torch.runtime import RuntimeModel
        runtime = RuntimeModel(compute_s=float(args.runtime))
    eng = HSGD(model.loss, sgd(0.1), topo,
               EngineConfig(comms="identity", runtime=runtime,
                            metrics="on"))
    state = eng.init(torch.Generator().manual_seed(args.seed), model.init,
                     device=dev)
    n = topo.n

    def batch_fn(t):
        rng = np.random.default_rng([args.seed, t])
        return {"x": rng.standard_normal((n, 8, 16)).astype(np.float32),
                "y": rng.integers(0, 4, (n, 8)).astype(np.int64)}

    recorder = TraceRecorder()
    state, hist = eng.run_rounds(state, batch_fn, args.steps,
                                 trace=recorder)

    for rec in hist:
        if "div_global" in rec:
            print(json.dumps({k: round(v, 6) if isinstance(v, float) else v
                              for k, v in rec.items()
                              if k in ("t", "lvl", "wire_bytes")
                              or k.startswith("div_")
                              or k == "grad_norm"}))

    errors = validate_trace(recorder)
    assert not errors, errors
    parent = os.path.dirname(args.out)
    if parent:
        os.makedirs(parent, exist_ok=True)
    recorder.save(args.out)
    print(json.dumps({"trace": args.out,
                      "trace_events": len(recorder.events),
                      "steps": args.steps, "backend": "sim",
                      "device": str(dev),
                      "sync_records": sum("div_global" in r for r in hist)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
