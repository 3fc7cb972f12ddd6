"""Fig. 3c: grouping effects — group-IID (upward divergence ~0) vs
group-non-IID, plus the measured divergences that explain the gap
(counterpart of the JAX package's ``benchmarks/fig3c_grouping.py``).

    PYTHONPATH=src python -m repro_torch.experiments.fig3c_grouping
"""
from __future__ import annotations

import torch

from repro_torch.core import (all_divergences, diversity_grouping, group_iid,
                              group_noniid, make_topology, per_worker_grads)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments.common import make_world, mean_trajectories
from repro_torch.models import params_from_numpy

N_WORKERS = 8


def groupings(ds, grads: torch.Tensor):
    """The label-oracle groupings (group-IID, group-non-IID) and the one
    built from the measured gradients (Remark 2, no label oracle)."""
    labels = ds.dominant_labels()
    return {"iid": group_iid(labels, 2), "non": group_noniid(labels, 2),
            "auto": diversity_grouping(grads.cpu().numpy(), 2)}


def measured(ds, model, dev, init_params=None):
    """Per-worker gradients at w0 (``init_params``, else the model's init
    from seed 0) on 64 examples a worker, the three groupings and each
    one's four divergences."""
    if init_params is not None:
        params0 = params_from_numpy(init_params, dev)
    else:
        params0 = model.init(torch.Generator().manual_seed(0), device=dev)
    grads = per_worker_grads(model.loss, params0, ds.full_per_worker(64))
    gs = groupings(ds, grads)
    return grads, gs, {k: all_divergences(grads, g) for k, g in gs.items()}


def main(quick: bool = True, device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    T = 96 if quick else 240
    G, I = 16, 4
    # 4 classes over 8 workers (each label on 2 workers) so that a
    # label-balanced 'group-IID' grouping exists (paper Fig 3c construction)
    ds, model = make_world(N_WORKERS, num_classes=4)
    seeds = (0, 1, 2) if quick else tuple(range(6))

    # measured divergences at w0 (the mechanism)
    _, gs, div = measured(ds, model, dev)

    def run(grouping, i):
        return mean_trajectories(
            ds, model,
            lambda: make_topology("grouped", grouping=grouping, G=G, I=i),
            T, seeds=seeds, device=dev)[-1]

    iid = run(gs["iid"], I)
    non = run(gs["non"], I)
    # Fig 3c second claim: group-IID ~ group-non-IID with I halved
    non_i2 = run(gs["non"], I // 2)
    # Remark 2, operationalized: the grouping from MEASURED gradients
    # should recover ~group-IID quality
    auto = run(gs["auto"], I)
    div_iid, div_non, div_auto = div["iid"], div["non"], div["auto"]

    print(f"# Fig 3c — grouping (T={T})")
    print("config,loss,acc,upward_div,downward_div")
    print(f"group-IID,{iid['loss']:.4f},{iid['acc']:.4f},"
          f"{div_iid['upward']:.3f},{div_iid['downward_avg']:.3f}")
    print(f"group-nonIID,{non['loss']:.4f},{non['acc']:.4f},"
          f"{div_non['upward']:.3f},{div_non['downward_avg']:.3f}")
    print(f"group-nonIID_I{I//2},{non_i2['loss']:.4f},{non_i2['acc']:.4f},,")
    print(f"diversity(measured-grads),{auto['loss']:.4f},{auto['acc']:.4f},"
          f"{div_auto['upward']:.3f},{div_auto['downward_avg']:.3f}")
    assert div_iid["upward"] < 0.1 * div_non["upward"]
    assert iid["loss"] <= non["loss"] + 0.02
    # the measured-gradient grouping must land near the label-oracle one
    assert div_auto["upward"] < 0.5 * div_non["upward"]
    assert auto["loss"] <= non["loss"] + 0.02
    return {"iid": iid["loss"], "non": non["loss"], "auto": auto["loss"],
            "upward_iid": div_iid["upward"], "upward_non": div_non["upward"],
            "upward_auto": div_auto["upward"]}


if __name__ == "__main__":
    main()
