"""Multi-level H-SGD (paper §5, Algorithm D.1): a 3-level hierarchy
(2 pods x 2 racks x 2 hosts) with nested periods P=(16, 4, 2) between the
extremes (Fig. E.8); the twin of the JAX package's
``examples/multilevel_hsgd.py``, at its sizes and seeds.

    PYTHONPATH=src python -m repro_torch.examples.multilevel_hsgd [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List

from repro_torch.core import HSGD, HierarchySpec, local_sgd, make_topology
from repro_torch.data import (FederatedDataset, label_shard_partition,
                              make_classification)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments.common import init_state, on_device
from repro_torch.models import SimpleConfig, SimpleModel
from repro_torch.optim import sgd

# the reference's four runs, in its order
RUNS = (("local SGD P=2 (best)", local_sgd(8, 2)),
        ("3-level P=(16,4,2)", HierarchySpec((2, 2, 2), (16, 4, 2))),
        ("2-level G=16, I=2", HierarchySpec((2, 4), (16, 2))),
        ("local SGD P=16 (worst)", local_sgd(8, 16)))


def main(device: DeviceLike = "cuda", init_params=None) -> List[Dict]:
    """Train each of :data:`RUNS` for 96 steps and print the final
    global loss of its mean params; ``init_params`` (numpy) stand in for
    the reference's ``model.init(PRNGKey(0))``.  Returns one record a
    run."""
    dev = resolve_device(device)
    x, y = make_classification(seed=3, num_classes=8, dim=24, per_class=80)
    ds = FederatedDataset(x, y, label_shard_partition(
        y, [[j] for j in range(8)]))
    model = SimpleModel(SimpleConfig(kind="mlp", input_dim=24, hidden=32,
                                     num_classes=8))
    gb = on_device(ds.global_batch(), dev)
    out = []
    for name, spec in RUNS:
        eng = HSGD(model.loss, sgd(0.08),
                   make_topology("uniform", spec=spec))
        st = init_state(eng, model, 0, dev, init_params)
        st, _ = eng.run_rounds(st, lambda t: ds.batch(t, 10), 96)
        loss = float(model.loss(eng.mean_params(st), gb)[0])
        print(f"{name:28s} final global loss {loss:.4f}")
        out.append({"run": name, "loss": loss})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
