"""Fig. E.8: 3-level H-SGD — mid-level aggregation helps, and the 3-level
sandwich (Remark 6) holds live (counterpart of the JAX package's
``benchmarks/fig_e8_multilevel.py``).

    PYTHONPATH=src python -m repro_torch.experiments.fig_e8_multilevel
"""
from __future__ import annotations

from repro_torch.core import HierarchySpec, local_sgd, make_topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments.common import make_world, mean_trajectories

N_WORKERS = 8


def main(quick: bool = True, device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    T = 96 if quick else 240
    ds, model = make_world(N_WORKERS)
    seeds = (0, 1, 2) if quick else tuple(range(6))

    def run(spec):
        return mean_trajectories(ds, model, lambda: make_topology(spec), T,
                                 seeds=seeds, device=dev)[-1]

    res = {
        "P=2 (best case)": run(local_sgd(N_WORKERS, 2)),
        "3lvl P=(16,4,2)": run(HierarchySpec((2, 2, 2), (16, 4, 2))),
        "3lvl P=(16,8,2)": run(HierarchySpec((2, 2, 2), (16, 8, 2))),
        "2lvl G=16,I=2": run(HierarchySpec((2, 4), (16, 2))),
        "P=16 (worst case)": run(local_sgd(N_WORKERS, 16)),
    }
    print(f"# Fig E.8 — multi-level (T={T})")
    print("config,loss,acc")
    for k, v in res.items():
        print(f"{k},{v['loss']:.4f},{v['acc']:.4f}")
    eps = 0.02
    assert res["P=2 (best case)"]["loss"] <= \
        res["3lvl P=(16,4,2)"]["loss"] + eps
    assert res["3lvl P=(16,4,2)"]["loss"] <= \
        res["P=16 (worst case)"]["loss"] + eps
    # more mid-level aggregation (P2=4 vs 8) should not hurt
    assert res["3lvl P=(16,4,2)"]["loss"] <= \
        res["3lvl P=(16,8,2)"]["loss"] + eps
    return {k: v["loss"] for k, v in res.items()}


if __name__ == "__main__":
    main()
