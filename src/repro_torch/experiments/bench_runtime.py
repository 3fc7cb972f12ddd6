"""Runtime benchmark: simulated time to target accuracy per participation
policy x straggler regime x topology (counterpart of the JAX package's
``benchmarks/bench_runtime.py``).

Every arm trains the runtime world (``make_world(n_workers=8,
num_classes=4)``, an MLP 24-32-32-4, ``sgd(LR)``, batch 10, T=96) under a
:class:`~repro_torch.runtime.RuntimeModel` and reads the SIMULATED clock
(host-side numpy): the times are exact host numbers, the same on any
device.  Three arms per regime: full barrier, deadline-elastic
(``DEADLINE_S`` over the subtree's median arrival) and async (the elastic
policy plus ``async_levels={1: 1}``).  The invariants are asserted as the
reference asserts them: monotone clocks in every arm, elastic never slower
than full barrier per step, every arm reaching the target.  The claims are
evaluated into ``claims`` (name -> ``{"holds": bool, "compared": [a, b]}``)
instead of raised one by one, so that a caller can read which hold:

* ``<topology>/none/elastic_equals_full_barrier``: a homogeneous fleet
  drops nobody, so the elastic arm is the full-barrier run (losses and
  clocks equal); compared: the two final simulated times;
* ``<topology>/<regime>/elastic_beats_full_barrier`` (every other regime):
  elastic publishes a target-accuracy global model in less simulated time;
* ``<topology>/bursty/async_beats_elastic``: the async arm beats elastic.

``backend="mesh"`` (or ``"both"``, the same) adds the reference's mesh
leg: in one :func:`~repro_torch.launch.mesh.launch` of eight ``gloo``
ranks (``device`` for every rank, all on one card), the elastic arm of
every regime and the async arm of bursty rerun through
``MeshExecutor(exact=True)``; their ``sim_time_s`` histories and eval
``acc`` must equal the sim arms' and ``ce`` lie within 1e-5 (asserted, as
the reference asserts them), and every rank must have the same clock and
drops.  They land as ``elastic_mesh`` and ``async_mesh`` beside the sim
arms, with the host steps/s of rank 0 and of the sim arm.

:func:`main` raises after the whole matrix if any claim is false, as the
reference's asserts would.  From the reference's initial params (the
committed ``data/runtime_world_init.npz``, exported by
``scripts/export_runtime_init.py``), ``three_level/bursty/
async_beats_elastic`` is false: 44.300119 >= 38.700197 s, as in the JAX
package's own run under the PRNG defaults of jax >= 0.5 (its
``BENCH_runtime.json`` was written under the older default draw, where the
async arm reaches the target one eval point earlier).

    PYTHONPATH=src python -m repro_torch.experiments.bench_runtime \
        [--backend sim|mesh|both] [--device cuda|cpu]
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import EngineConfig, HSGD, HierarchySpec, make_topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments.common import (init_state, make_world,
                                            on_device, sync)
from repro_torch.optim import sgd
from repro_torch.runtime import LinkModel, RuntimeModel
from repro_torch.tree import tree_map

# near-vs-far link ladders (outermost = level 1 = the slow fabric); payloads
# here are tiny, so latency dominates
TOPOLOGIES = {
    "two_level": (HierarchySpec((2, 4), (8, 2)),
                  (LinkModel(4.0, 1e8), LinkModel(0.1, 1e9))),
    "three_level": (HierarchySpec((2, 2, 2), (8, 4, 2)),
                    (LinkModel(4.0, 1e8), LinkModel(0.2, 1e9),
                     LinkModel(0.05, 1e10))),
}

REGIMES = {
    "none": None,
    "fixed": "fixed:0.125:8",          # one worker permanently 8x slower
    "lognormal": "lognormal:0.8",      # heavy-tailed per-step jitter
    "bursty": "bursty:0.25:0.5:2.5",   # frequent short 2.5x stalls
}

COMPUTE_S = 1.0
LR = 0.05
TARGET_FRAC = 0.97  # of the weakest arm's best accuracy
DEADLINE_S = 2.0    # slack over the subtree's median arrival, every level
SEED = 1
STALE = {1: 1}      # the async arm: level 1 one period late
MESH_WORKERS = 8    # one gloo rank per worker of the mesh leg
MESH_TIMEOUT = 900.0
MESH_CE_ATOL = 1e-5  # benchmarks/bench_runtime.py's mesh-vs-sim ce bound

ROOT = Path(__file__).resolve().parents[3]
INIT = Path(__file__).resolve().parent / "data" / "runtime_world_init.npz"
OUT = ROOT / "build" / "BENCH_runtime_torch.json"


def load_init_params(path: Path = INIT) -> Dict:
    """The reference's initial params of the runtime world (nested dicts
    of numpy arrays, ``"<layer>/<name>"`` keys in the file)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as z:
        for key in z.files:
            layer, name = key.split("/")
            out.setdefault(layer, {})[name] = z[key]
    return out


def run_arm(ds, model, spec, links, straggler, deadline, T, eval_every=8,
            async_levels=None, device: DeviceLike = "cuda",
            init_params=None, executor=None):
    """One arm on the sim executor, or ``executor``: returns the engine,
    its history and the host seconds of ``run_rounds`` (after a
    ``synchronize``; evals included when ``eval_every``)."""
    dev = resolve_device(device)
    topo = make_topology("uniform", spec=spec)
    rt = RuntimeModel(compute_s=COMPUTE_S, links=links, straggler=straggler,
                      policy=deadline, seed=SEED)
    eng = HSGD(model.loss, sgd(LR), topo,
               EngineConfig(runtime=rt, async_levels=async_levels,
                            executor=executor))
    st = init_state(eng, model, 0, dev, init_params)
    gb = on_device(ds.global_batch(640), dev)

    def evaluate(state, t):
        # the PUBLISHED global model: every eval point sits right after a
        # global sync, whose admitted workers hold the aggregate at the
        # barrier-completion time last_sync_time[1]
        clock = eng._last_clock
        adm = clock.last_admitted.get(1)
        adm = np.ones(topo.n, bool) if adm is None else adm
        keep = torch.as_tensor(adm, device=dev)
        wbar = tree_map(
            lambda x: x[keep].mean(0, dtype=torch.float32).to(x.dtype),
            eng.executor.gather(state.params))
        return {"acc": float(model.accuracy(wbar, gb)),
                "pub_time_s": round(clock.last_sync_time.get(1,
                                                             clock.time_s), 6)}

    t0 = time.perf_counter()
    st, hist = eng.run_rounds(st, lambda t: ds.batch(t, 10), T,
                              eval_every=eval_every,
                              eval_fn=evaluate if eval_every else None)
    sync(dev)
    return eng, hist, time.perf_counter() - t0


def time_to_target(hist, target_acc):
    """First eval point at target: (step, published-model time, makespan)."""
    for rec in hist:
        if rec.get("acc", -1.0) >= target_acc:
            return rec["t"], rec["pub_time_s"], rec["sim_time_s"]
    return None, None, None


def _accs(hist):
    return [r["acc"] for r in hist if "acc" in r]


def _record(rep, hist, steps, t_pub, t_make):
    return {"steps_to_target": steps,
            "time_to_target_s": t_pub,          # published-model time
            "makespan_at_target_s": t_make,     # incl. dropped clocks
            "total_sim_time_s": hist[-1]["sim_time_s"],
            "final_sync_s": hist[-1]["sim_sync_s"],
            "best_acc": round(max(_accs(hist)), 4),
            "dropped": rep["dropped"], "synced": rep["synced"]}


def bench_regime(ds, model, spec, links, tname, rname, straggler, T,
                 device: DeviceLike = "cuda", init_params=None,
                 arms_out: Optional[Dict] = None):
    """The three arms of one regime.  Returns ``(record, claims)``: the
    reference's record and this regime's claims.  ``arms_out``, if given,
    receives each arm's ``(history, seconds)`` and the unrounded target
    (the mesh leg is held against them)."""
    arms = {
        "full_barrier": run_arm(ds, model, spec, links, straggler, None, T,
                                device=device, init_params=init_params),
        "elastic": run_arm(ds, model, spec, links, straggler, DEADLINE_S, T,
                           device=device, init_params=init_params),
        "async": run_arm(ds, model, spec, links, straggler, DEADLINE_S, T,
                         async_levels=STALE, device=device,
                         init_params=init_params),
    }
    hists = {k: h for k, (_, h, _) in arms.items()}
    times = {k: [r["sim_time_s"] for r in h] for k, h in hists.items()}
    for k, ts in times.items():
        assert all(a <= b for a, b in zip(ts, ts[1:])), \
            f"{k} time ran backwards"
    assert all(e <= f + 1e-9 for e, f in zip(times["elastic"],
                                             times["full_barrier"])), \
        "elastic exceeded full-barrier simulated time"
    target = TARGET_FRAC * min(max(_accs(h)) for h in hists.values())
    hit = {k: time_to_target(h, target) for k, h in hists.items()}
    assert all(v[1] is not None for v in hit.values()), \
        "an arm never reached target"
    rec = {"target_acc": round(target, 4)}
    for k, (eng, hist, _) in arms.items():
        rec[k] = _record(eng.runtime_report(), hist, *hit[k])
    if arms_out is not None:
        arms_out.update({k: (h, s) for k, (_, h, s) in arms.items()},
                        target=target)
    rec["async"]["async_levels"] = {f"L{l}": s for l, s in STALE.items()}
    ttf, tte, tta = (hit[k][1] for k in ("full_barrier", "elastic", "async"))
    rec["speedup_at_target"] = round(ttf / tte, 4)
    rec["speedup_async_vs_elastic"] = round(tte / tta, 4)

    def claim(holds, a, b):
        return {"holds": bool(holds), "compared": [float(a), float(b)]}

    claims = {}
    if rname == "none":
        same = [r["ce"] for r in hists["full_barrier"]] == \
            [r["ce"] for r in hists["elastic"]] and \
            times["full_barrier"] == times["elastic"]
        claims[f"{tname}/{rname}/elastic_equals_full_barrier"] = claim(
            same, times["elastic"][-1], times["full_barrier"][-1])
    else:
        claims[f"{tname}/{rname}/elastic_beats_full_barrier"] = claim(
            tte < ttf, tte, ttf)
    if rname == "bursty":
        claims[f"{tname}/{rname}/async_beats_elastic"] = claim(
            tta < tte, tta, tte)
    return rec, claims


def _mesh_arms(rname):
    """The arms the mesh leg reruns in a regime: elastic, and async under
    bursty (the reference's ``elastic_mesh`` and ``async_mesh``)."""
    return (("elastic", None),) + ((("async", STALE),)
                                   if rname == "bursty" else ())


def mesh_leg(rank: int, T: int, device: str, init_params, cells) -> Dict:
    """One rank of the mesh leg (run it under :func:`~repro_torch.launch.
    mesh.launch` with MESH_WORKERS ranks): for each ``(topology, regime)``
    of ``cells`` the arms of :func:`_mesh_arms` through
    ``MeshExecutor(exact=True)``.  Returns ``{"arms": {"<t>/<r>/<arm>":
    {"history", "report", "seconds"}}, "ranks_agree": bool}`` (rank 0's
    arms; ``ranks_agree``: every rank has the same clock, drops and
    evals)."""
    import torch.distributed as dist
    from repro_torch.core import MeshExecutor
    ds, model = make_world(n_workers=8, num_classes=4)
    arms = {}
    for tname, rname in cells:
        spec, links = TOPOLOGIES[tname]
        for arm, al in _mesh_arms(rname):
            eng, hist, secs = run_arm(
                ds, model, spec, links, REGIMES[rname], DEADLINE_S, T,
                async_levels=al, device=device, init_params=init_params,
                executor=MeshExecutor(exact=True))
            arms[f"{tname}/{rname}/{arm}"] = {
                "history": hist, "report": eng.runtime_report(),
                "seconds": secs}
    mine = {k: [(r["sim_time_s"], r.get("dropped"), r.get("acc"))
                for r in v["history"]] for k, v in arms.items()}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return {"arms": arms, "ranks_agree": all(e == mine for e in everyone)}


def _hold_mesh_arm(key, mesh, sim_hist):
    """The reference's assertions on a mesh arm against its sim arm."""
    hist = mesh["history"]
    assert [r["sim_time_s"] for r in hist] == \
        [r["sim_time_s"] for r in sim_hist], \
        f"{key}: mesh clock diverged from sim"
    assert [r.get("dropped") for r in hist] == \
        [r.get("dropped") for r in sim_hist], \
        f"{key}: mesh drops diverged from sim"
    # the exact mesh replays the sim's params, so the published model's
    # accuracy is equal; the ce metric is meaned in another order
    assert [r.get("acc") for r in hist] == [r.get("acc") for r in sim_hist], \
        f"{key}: mesh(exact) trajectory diverged from sim"
    ce = max(abs(a["ce"] - b["ce"]) for a, b in zip(hist, sim_hist))
    assert ce < MESH_CE_ATOL, f"{key}: mesh ce {ce} from sim"
    return ce


def matrix(quick: bool = True, device: DeviceLike = "cuda",
           init_params=None, topologies=None, regimes=None,
           backend: str = "sim", steps: Optional[int] = None) -> Dict:
    """Every topology x regime (or the named subsets): the report, with
    ``claims`` beside ``topologies``.  ``init_params`` None starts from the
    reference's committed params.  ``backend`` "mesh" or "both" adds the
    mesh leg (module docstring).  ``steps`` overrides the run length (96,
    or 384 at ``quick=False``), for a shallower mesh leg.  Raises on a
    broken invariant or a mesh arm that is not the sim's, never on a false
    claim."""
    if backend not in ("sim", "mesh", "both"):
        raise ValueError(f"backend must be 'sim', 'mesh' or 'both', got "
                         f"{backend!r}")
    ds, model = make_world(n_workers=8, num_classes=4)
    if init_params is None:
        init_params = load_init_params()
    T = steps or (96 if quick else 384)
    report = {"steps": T, "compute_s": COMPUTE_S, "deadline_s": DEADLINE_S,
              "backend": backend, "device": resolve_device(device).type,
              "topologies": {}, "claims": {}}
    sims: Dict = {}
    for tname in topologies or TOPOLOGIES:
        spec, links = TOPOLOGIES[tname]
        row = {"spec": {"group_sizes": spec.group_sizes,
                        "periods": spec.periods},
               "links": [{"latency_s": l.latency_s,
                          "bandwidth_Bps": l.bandwidth_Bps} for l in links]}
        for rname in regimes or REGIMES:
            sims[tname, rname] = {}
            row[rname], claims = bench_regime(
                ds, model, spec, links, tname, rname, REGIMES[rname], T,
                device=device, init_params=init_params,
                arms_out=sims[tname, rname])
            report["claims"].update(claims)
        report["topologies"][tname] = row
    if backend != "sim":
        from repro_torch.launch.mesh import launch
        leg = launch(mesh_leg, MESH_WORKERS, backend="gloo",
                     device=resolve_device(device).type,
                     args=(T, resolve_device(device).type, init_params,
                           tuple(sims)), timeout=MESH_TIMEOUT)
        assert leg["ranks_agree"], \
            "mesh leg: the ranks' clocks, drops or evals differ"
        for (tname, rname), sim in sims.items():
            for arm, _ in _mesh_arms(rname):
                key = f"{tname}/{rname}/{arm}"
                mesh = leg["arms"][key]
                sim_hist, sim_s = sim[arm]
                ce = _hold_mesh_arm(key, mesh, sim_hist)
                hist = mesh["history"]
                report["topologies"][tname][rname][f"{arm}_mesh"] = dict(
                    _record(mesh["report"], hist,
                            *time_to_target(hist, sim["target"])),
                    backend="mesh(exact)", ranks=MESH_WORKERS,
                    max_abs_ce_diff_vs_sim=ce,
                    steps_per_s=T / mesh["seconds"],
                    sim_steps_per_s=T / sim_s)
    return report


def main(quick: bool = True, out: Optional[str] = str(OUT),
         device: DeviceLike = "cuda", init_params=None,
         backend: str = "sim") -> Dict:
    """The whole matrix; writes the report to ``out`` (None: nowhere; never
    the JAX package's tracked ``BENCH_runtime.json``), prints the
    speedups, then raises if any claim is false."""
    if out is not None and Path(out).name == "BENCH_runtime.json":
        raise ValueError("the port writes its own report, never the "
                         "reference's BENCH_runtime.json")
    report = matrix(quick, device, init_params, backend=backend)
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {out}")
    print(json.dumps({t: {r: row[r]["speedup_at_target"] for r in REGIMES
                          if r in row}
                      for t, row in report["topologies"].items()}))
    false = {k: v["compared"] for k, v in report["claims"].items()
             if not v["holds"]}
    assert not false, f"claims that do not hold (compared): {false}"
    return report


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="sim",
                    choices=["sim", "mesh", "both"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(device=args.device, backend=args.backend)
