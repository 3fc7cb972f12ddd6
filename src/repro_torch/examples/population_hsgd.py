"""Population-scale H-SGD: one million virtual clients, eight active
slots; the twin of the JAX package's ``examples/population_hsgd.py``, at
its sizes and seeds.

    PYTHONPATH=src python -m repro_torch.examples.population_hsgd [--device cpu]

The engine state only ever holds the k = topology.n active slots; the
1,000,000-client population is a sampling law (pure in ``(seed, round)``)
plus per-client shard specs (pure in ``(seed, client_id, step)``), both
host numpy, so the draws are the reference's.  Each sampling round draws
8 clients hierarchically (2 of 1000 cells, then 4 of 1000 clients per
cell), runs one global period of the H-SGD engine, and folds the result
back into the server model with dataset-size weights.
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import torch

from repro_torch.core import EngineConfig, HSGD, make_topology
from repro_torch.data import PopulationShards
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import SimpleConfig, SimpleModel, params_from_numpy
from repro_torch.optim import sgd
from repro_torch.population import Population


def main(device: DeviceLike = "cuda", init_params=None) -> List[Dict]:
    """Run 12 sampling rounds and print each round's step, train loss and
    clients seen; ``init_params`` (numpy) stand in for the reference's
    ``model.init(PRNGKey(0))``.  Returns one record a round."""
    dev = resolve_device(device)
    # a 10-class Gaussian mixture, sharded label-skewed over 10^6 virtual
    # clients (2 labels each, lognormal dataset sizes)
    shards = PopulationShards(population=1_000_000, num_classes=10, dim=24,
                              seed=0)
    model = SimpleModel(SimpleConfig(kind="mlp", input_dim=24, hidden=32,
                                     num_classes=10))

    # topology over the 8 ACTIVE slots (2 cells x 4 clients); the
    # population declares 1000x1000 cells behind them
    topology = make_topology("two_level", n=8, N=2, G=8, I=2)
    engine = HSGD(model.loss, sgd(0.08), topology, EngineConfig(
        population=Population(cells=(1000, 1000), seed=7,
                              weighting="size")))

    if init_params is None:
        server = engine.init_server(torch.Generator().manual_seed(0),
                                    model.init, device=dev)
    else:
        server = engine.init_server_from_params(
            params_from_numpy(init_params, dev), device=dev)
    server, history = engine.run_sampled(
        server, shards.batch_fn(batch_size=10), rounds=12,
        sizes=shards.size_fn())

    out = []
    for rec in history:
        p = rec["participation"]
        print(f"round {rec['round']:2d}  step {rec['t']:3d}  "
              f"train loss {rec['ce']:.4f}  "
              f"clients seen {p['unique']:3d}/{p['population']}")
        out.append({"round": rec["round"], "t": rec["t"], "ce": rec["ce"],
                    "unique": p["unique"], "population": p["population"]})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
