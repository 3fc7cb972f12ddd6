"""Quickstart: two-level H-SGD on a non-IID problem; the twin of the JAX
package's ``examples/quickstart.py``, at its sizes and seeds.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List

from repro_torch.core import EngineConfig, HSGD, make_topology
from repro_torch.data import (FederatedDataset, label_shard_partition,
                              make_classification)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments.common import init_state, on_device
from repro_torch.models import SimpleConfig, SimpleModel
from repro_torch.optim import sgd


def main(device: DeviceLike = "cuda", init_params=None) -> List[Dict]:
    """Train and print the loss and accuracy of the mean params at every
    16th step; ``init_params`` (numpy, the reference's layout) stand in
    for the reference's ``model.init(PRNGKey(0))``.  Returns one record
    per printed line."""
    dev = resolve_device(device)
    # 8 workers, each holding ONE class of a 8-class problem (maximally
    # non-IID)
    x, y = make_classification(seed=0, num_classes=8, dim=24, per_class=80)
    ds = FederatedDataset(x, y, label_shard_partition(
        y, [[j] for j in range(8)], n_workers=8))
    ds.require_workers(8)  # fail here, not as a shape error mid-round

    model = SimpleModel(SimpleConfig(kind="mlp", input_dim=24, hidden=32,
                                     num_classes=8))

    # H-SGD: 2 groups x 4 workers; local aggregation every I=4 steps,
    # global aggregation every G=16 steps
    topology = make_topology("two_level", n=8, N=2, G=16, I=4)
    engine = HSGD(model.loss, sgd(0.08), topology, EngineConfig())
    state = init_state(engine, model, 0, dev, init_params)

    gb = on_device(ds.global_batch(), dev)

    def evaluate(state, t):
        wbar = engine.mean_params(state)  # observable at global boundaries
        return {"loss": float(model.loss(wbar, gb)[0]),
                "acc": float(model.accuracy(wbar, gb))}

    state, history = engine.run_rounds(
        state, lambda t: ds.batch(t, 10), T=96, eval_every=16,
        eval_fn=evaluate)

    out = []
    for rec in history:
        if "acc" in rec:
            event = engine.topology.event_at(rec["t"] - 1)
            print(f"step {rec['t']:3d}  sync=level-{event.level}  "
                  f"global loss {rec['loss']:.4f}  acc {rec['acc']:.3f}")
            out.append({"step": rec["t"], "level": event.level,
                        "loss": rec["loss"], "acc": rec["acc"]})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
