"""Figs. E.4-E.6: partial worker participation — H-SGD retains its advantage
over local SGD when only a fraction of workers participate per round
(counterpart of the JAX package's ``benchmarks/fig_e4_participation.py``;
the engine takes ``EngineConfig()`` where the reference passes its legacy
``jit=True``).

    PYTHONPATH=src python -m repro_torch.experiments.fig_e4_participation
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import (HSGD, EngineConfig, local_sgd, make_topology,
                              sample_participation, two_level)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments.common import init_state, make_world, on_device
from repro_torch.optim import sgd

N_WORKERS = 16
FRAC = 0.5


def run(ds, model, spec, T, seed, frac=FRAC, device: DeviceLike = "cuda",
        init_params=None):
    dev = resolve_device(device)
    topo = make_topology(spec)
    eng = HSGD(model.loss, sgd(0.08), topo, EngineConfig())
    st = init_state(eng, model, seed, dev, init_params)
    sizes = (spec.group_sizes[0],
             spec.n_workers // spec.group_sizes[0])
    round_len = spec.periods[-1]
    mask = None
    for t in range(T):
        if t % round_len == 0:  # re-sample per aggregation round (paper E)
            mask = sample_participation(sizes, frac, seed * 10_000 + t)
        st, _ = eng.step(st, ds.batch(t, 10), mask=mask)
    gb = on_device(ds.global_batch(640), dev)
    wbar = eng.mean_params(st)
    return float(model.loss(wbar, gb)[0]), float(model.accuracy(wbar, gb))


def main(quick: bool = True, device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    T = 96 if quick else 240
    ds, model = make_world(N_WORKERS, num_classes=8)
    seeds = (0, 1, 2) if quick else tuple(range(6))
    G, I = 16, 4

    res = {}
    for name, spec in [
        ("localSGD_P=4 (50% part.)", local_sgd(N_WORKERS, I)),
        ("hsgd G=16,I=4 (50% part.)", two_level(N_WORKERS, 2, G, I)),
        ("localSGD_P=16 (50% part.)", local_sgd(N_WORKERS, G)),
    ]:
        outs = [run(ds, model, spec, T, s, device=dev) for s in seeds]
        res[name] = {"loss": float(np.mean([o[0] for o in outs])),
                     "acc": float(np.mean([o[1] for o in outs]))}
    print(f"# Fig E.4-E.6 — partial participation (frac={FRAC}, T={T}, "
          f"n={N_WORKERS})")
    print("config,loss,acc")
    for k, v in res.items():
        print(f"{k},{v['loss']:.4f},{v['acc']:.4f}")
    eps = 0.02
    ks = list(res)
    assert res[ks[0]]["loss"] <= res[ks[1]]["loss"] + eps   # sandwich holds
    assert res[ks[1]]["loss"] <= res[ks[2]]["loss"] + eps   # under sampling
    return {k: v["loss"] for k, v in res.items()}


if __name__ == "__main__":
    main()
