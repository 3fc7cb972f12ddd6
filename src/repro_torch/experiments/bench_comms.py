"""Communication benchmark: bytes a step and steps/s per codec x topology
(counterpart of the JAX package's ``benchmarks/bench_comms.py``).

The paper's thesis is convergence per COMMUNICATION COST; this benchmark
makes the cost side concrete.  For each codec (off / identity / int8 /
sign / topk) on a 2-level and a 3-level hierarchy it records

* the static wire accounting (``repro_torch.comms.WireStats``): per-worker
  payload bytes, per-level bytes per sync, bytes a step over the schedule
  and the payload reduction against f32 (int8 ~4x, sign ~30x);
* each sync event's op count from the audit (:mod:`repro_torch.analysis`),
  asserted equal to the schedule's prediction: the O(dtypes)-vs-O(leaves)
  claim;
* measured steps/s of the live training harness (sim executor), so that
  a codec's compute shows beside its byte savings.

The byte ratios are asserted (static: no timing noise): int8 > 3.5, sign
> 20, identity 1.0, int8 below identity.  ``--wall-clock`` adds the timed
leg on the two-level hierarchy: interleaved best-of-``WALL_REPEATS``
steps/s per codec, the legacy ``wire_reduce=False`` lowering of int8 and
sign included, and each codec's L1 sync timed alone over many calls.  Its
two bounds are the reference's: identity within 5% of comms-off on the
best same-repeat pairing, and the int8 and sign compressed syncs faster
than their legacy roundtrips on mean sync latency.  The timed leg runs the
sim executor: the reference adds a mesh leg where it has a device per
worker, and the port's mesh shares one card and one host among its ranks,
whose wall clock the reference never gates on either.

The engine takes its comms plan through ``EngineConfig``; the port has no
deprecated keyword shim (``HSGD(..., comms=...)``).  Writes
``build/BENCH_comms_torch.json`` (the reference's ``BENCH_comms.json`` is
its own record and is refused as an output name).

    PYTHONPATH=src python -m repro_torch.experiments.bench_comms \
        [--smoke] [--full] [--wall-clock] [--out PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import torch

from repro_torch.comms import Comms
from repro_torch.core import EngineConfig, HSGD, HierarchySpec, make_topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments.common import make_world, steps_per_sec, sync
from repro_torch.optim import sgd
from repro_torch.tree import tree_map

TOPOLOGIES = {
    "two_level": HierarchySpec((2, 4), (8, 2)),
    "three_level": HierarchySpec((2, 2, 2), (8, 4, 2)),
}

CODECS = {
    "off": None,                       # comms disabled: the baseline path
    "identity": Comms("identity"),     # FlatBucket fusion, exact values
    "int8": Comms("int8"),
    "sign": Comms("sign"),
    "topk": Comms("topk"),
}

# the pre-compressed-collective lowering of the same codecs: encode, reduce
# the DECODED f32 payload, decode — what the wire path has to beat
LEGACY = {
    "int8-legacy": Comms("int8", wire_reduce=False),
    "sign-legacy": Comms("sign", wire_reduce=False),
}

# every repeat times ALL variants back to back and each keeps its best:
# the bests sample the same machine state, so ratios between them compare
WALL_REPEATS = 3
SYNC_ITERS = 1500
OUT = "build/BENCH_comms_torch.json"
REFERENCE_FILE = "BENCH_comms.json"


def wall_clock_leg(ds, model, spec: HierarchySpec, T: int,
                   device: DeviceLike = "cuda") -> Dict:
    """Interleaved best-of-``WALL_REPEATS`` steps/s per codec (and the
    legacy roundtrip variants) on the sim executor, unrounded."""
    variants = dict(CODECS)
    variants.update(LEGACY)
    runs = {name: [] for name in variants}
    for rep in range(WALL_REPEATS):
        for name, comms in variants.items():
            topo = make_topology("uniform", spec=spec)
            runs[name].append(steps_per_sec(
                ds, model, topo, T=T, backend="sim", comms=comms,
                device=device))
        print(f"... wall-clock sim rep {rep}: " + " ".join(
            f"{n}={runs[n][-1]:.0f}" for n in runs), flush=True)
    return {"sim": {name: {"steps_per_sec_best": max(v),
                           "steps_per_sec_all": v}
                    for name, v in runs.items()}}


def sync_latency_leg(model, spec: HierarchySpec, iters: int = SYNC_ITERS,
                     device: DeviceLike = "cuda") -> Dict:
    """Wall clock of each codec's L1 sync (the sim arithmetic, what both
    executors' wire paths run), in microseconds: the min over
    ``WALL_REPEATS`` interleaved passes of an ``iters``-call mean, a
    ``synchronize`` at each pass's two ends."""
    from repro_torch.comms.reduce import SimWireOps
    from repro_torch.core.topology import SyncEvent

    dev = resolve_device(device)
    topo = make_topology("uniform", spec=spec)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    n = spec.n_workers
    gen = torch.Generator().manual_seed(1)
    tree = tree_map(lambda x: torch.randn((n,) + tuple(x.shape),
                                          generator=gen).to(dev), params)
    ev = SyncEvent(level=1)
    ops = SimWireOps(spec.group_sizes, 1)

    def reduce_fn(t):
        return topo.aggregate(t, ev)

    variants = dict(CODECS)
    variants.update(LEGACY)
    fns = {}
    for name, comms in variants.items():
        if comms is None:
            fns[name] = reduce_fn
        elif comms.wire_reduce and comms.codec.wire_reduce:
            fns[name] = lambda t, c=comms: c.sync(t, reduce_fn,
                                                  reduce_mode=ops)
        else:
            fns[name] = lambda t, c=comms: c.sync(t, reduce_fn)
    out = {name: float("inf") for name in fns}
    for _ in range(WALL_REPEATS):
        for name, fn in fns.items():
            fn(tree)
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(tree)
            sync(dev)
            us = (time.perf_counter() - t0) / iters * 1e6
            out[name] = min(out[name], us)
    print("... sync latency (us, min of interleaved means): " + " ".join(
        f"{n}={v:.1f}" for n, v in out.items()), flush=True)
    return out


def bench_one(ds, model, spec: HierarchySpec, comms, T: int, measure: bool,
              device: DeviceLike = "cuda") -> Dict:
    """One (topology, codec) record: the static wire accounting, the
    audited sync-op counts (asserted against the schedule) and, with
    ``measure``, steps/s through ``run_rounds``."""
    dev = resolve_device(device)
    topo = make_topology("uniform", spec=spec)
    eng = HSGD(model.loss, sgd(0.08), topo, EngineConfig(comms=comms))
    state = eng.init(torch.Generator().manual_seed(0), model.init,
                     device=dev)
    rec: Dict = {}
    ws = eng.wire_stats(state)
    if ws is not None:
        rec.update(ws.summary(T))
    # the audit of the recorded sync programs: the O(dtypes)-vs-O(leaves)
    # claim per sync level, asserted against the schedule prediction
    audit = eng.audit(state)
    rec["sync_ops"] = {k: ev.sync_ops for k, ev in audit.events.items()}
    for ev in audit.events.values():
        assert ev.sync_ops == ev.expected_sync_ops, \
            f"recorded sync op count drifted: {ev}"
    if measure:
        rec["steps_per_sec"] = steps_per_sec(
            ds, model, make_topology("uniform", spec=spec), T=T,
            use_rounds=True, warmup=spec.G, comms=comms, device=dev)
    return rec


def run(quick: bool = True, measure: bool = True, wall_clock: bool = False,
        device: DeviceLike = "cuda") -> Dict:
    """The records of both topologies x every codec, the static ratios
    asserted, and with ``wall_clock`` the timed legs (their bounds are
    :func:`check_wall_clock`'s)."""
    dev = resolve_device(device)
    ds, model = make_world(n_workers=8)
    T = 64 if quick else 512
    report: Dict = {"steps": T, "device": str(dev), "topologies": {}}
    for tname, spec in TOPOLOGIES.items():
        row: Dict = {"spec": {"group_sizes": list(spec.group_sizes),
                              "periods": list(spec.periods)}}
        for cname, comms in CODECS.items():
            print(f"... {tname} / {cname}", flush=True)
            row[cname] = bench_one(ds, model, spec, comms, T, measure, dev)
        # static sanity: the whole point of the codecs
        ident = row["identity"]["payload_bytes_per_worker"]
        assert row["int8"]["compression_ratio"] > 3.5, row["int8"]
        assert row["sign"]["compression_ratio"] > 20.0, row["sign"]
        assert row["identity"]["compression_ratio"] == 1.0
        assert row["int8"]["payload_bytes_per_worker"] < ident
        report["topologies"][tname] = row
    if wall_clock:
        spec = TOPOLOGIES["two_level"]
        steps = 256 if quick else 1024
        report["wall_clock"] = {
            "repeats": WALL_REPEATS, "steps": steps,
            "two_level": wall_clock_leg(ds, model, spec, steps, dev),
            "sync_latency_us": sync_latency_leg(model, spec, SYNC_ITERS,
                                                dev)}
    return report


def check_wall_clock(report: Dict) -> Dict[str, bool]:
    """The wall-clock contract of the compressed-collective lowering, each
    bound as the reference states it: (1) identity pays nothing over
    comms-off on the best SAME-REPEAT pairing (within 5%); (2) the int8
    and sign wire paths beat their own legacy encode→reduce(f32)→decode
    roundtrip on mean sync latency."""
    wc = report["wall_clock"]
    sim, lat = wc["two_level"]["sim"], wc["sync_latency_us"]
    pairs = [i / o for i, o in zip(sim["identity"]["steps_per_sec_all"],
                                   sim["off"]["steps_per_sec_all"])]
    return {"identity_within_5pct_of_off": max(pairs) >= 0.95,
            "int8_beats_legacy": lat["int8"] < lat["int8-legacy"],
            "sign_beats_legacy": lat["sign"] < lat["sign-legacy"]}


def main(quick: bool = True, out: str = OUT, measure: bool = True,
         wall_clock: bool = False, device: DeviceLike = "cuda") -> Dict:
    """Run, write ``out`` and assert the bounds; returns the compression
    ratios per topology and codec."""
    if os.path.basename(out) == REFERENCE_FILE:
        raise ValueError(f"{REFERENCE_FILE} is the JAX package's record; "
                         f"write the port's elsewhere (default {OUT})")
    report = run(quick, measure, wall_clock, device)
    if wall_clock:
        report["wall_clock"]["bounds"] = check_wall_clock(report)
    parent = os.path.dirname(out)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}")
    summary = {t: {c: row[c].get("compression_ratio")
                   for c in CODECS if c != "off"}
               for t, row in report["topologies"].items()}
    print(json.dumps(summary))
    if wall_clock:
        bounds = report["wall_clock"]["bounds"]
        assert all(bounds.values()), (bounds, report["wall_clock"])
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="short run, no throughput timing")
    ap.add_argument("--full", action="store_true", help="longer runs")
    ap.add_argument("--wall-clock", action="store_true",
                    help="timed leg: steps/s per codec with the legacy "
                         "variants and the sync latencies, with the "
                         "identity-overhead and legacy-beating bounds "
                         "asserted")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(quick=not args.full, out=args.out, measure=not args.smoke,
         wall_clock=args.wall_clock, device=args.device)
