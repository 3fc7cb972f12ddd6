#!/usr/bin/env python3
"""Export the JAX package's initial params of the runtime benchmark's world
for the PyTorch port.

    PYTHONPATH=src python3 scripts/export_runtime_init.py [--out PATH]

``benchmarks/bench_runtime.py`` starts every arm from
``model.init(jax.random.PRNGKey(0))`` of ``make_world(n_workers=8,
num_classes=4)`` (an MLP 24-32-32-4).  The port does not re-implement
JAX's PRNG, and whether the async arm reaches its target before the
elastic one depends on that draw, so its twin
(``repro_torch.experiments.bench_runtime``) starts from these values,
written to ``src/repro_torch/experiments/data/runtime_world_init.npz``
with one array per leaf under the key ``"<layer>/<name>"``.  The draw
depends on the installed JAX's PRNG defaults; the tier-1 test
``tests/test_torch_experiments.py`` holds the committed file bit for bit
against :func:`reference_params` under the installed JAX.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "src" / "repro_torch" / "experiments" / "data" / \
    "runtime_world_init.npz"


def reference_params() -> dict:
    """The reference's params of the runtime world, as nested dicts of
    numpy float32 arrays."""
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import jax
    from benchmarks.common import make_world
    _, model = make_world(n_workers=8, num_classes=4)
    return jax.device_get(model.init(jax.random.PRNGKey(0)))


def flat(params: dict) -> dict:
    return {f"{layer}/{name}": np.asarray(v)
            for layer, leaves in params.items() for name, v in leaves.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    arrays = flat(reference_params())
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez(args.out, **arrays)
    print(f"wrote {args.out}: {sum(a.size for a in arrays.values())} values "
          f"in {len(arrays)} arrays")


if __name__ == "__main__":
    main()
