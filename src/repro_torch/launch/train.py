"""End-to-end H-SGD training entry point (PyTorch counterpart of
``repro.launch.train``, with the same flag groups, flags, defaults, error
messages, JSONL header and records).

Builds the model from --arch (a reduced variant with --reduced), an H-SGD
topology (--workers/--groups/--G/--I, or --levels for multi-level), the
synthetic token pipeline (:mod:`repro_torch.data.synthetic`), and trains
through ``HSGD.run_rounds`` with periodic checkpoints and divergence
telemetry.  It runs on the CUDA card unless the caller asks for the CPU
(``main(argv, device="cpu")``).  The LM trains on its plain path through
autograd (``use_kernels`` stays False, as ``use_pallas`` does in the
reference's ``launch.train``); the codec kernels run at every sync.  An
MoE architecture trains on the same ``loss``, its load-balance aux term
included.  An encoder-decoder raises ``ValueError``: the token stream has
no encoder frames for its loss, and the reference's driver fails there too.

``--backend mesh`` runs the same entry point in ``prod(level sizes)`` spawned
processes, one per worker, joined in a ``gloo`` world on the one card
(:func:`repro_torch.launch.mesh.launch`); rank 0 prints and returns the
history.  Checkpoints then gather every rank's rows and rank 0 writes.

``--runtime`` prices the schedule in simulated seconds
(:mod:`repro_torch.runtime`), ``--probes`` measures the per-level
divergences in the round body (:mod:`repro_torch.obs`), ``--trace``
exports the run as Chrome-trace JSON, and ``--population`` switches to
sampled participation from a virtual-client population
(:meth:`HSGD.run_sampled`; --steps must then be a multiple of G).
``--audit`` prints the collective audit of the sync plan
(:mod:`repro_torch.analysis`, sync subprograms only).

The initial params come from :func:`init_params` and the batches from
:func:`make_stream` / :func:`make_client_batches`: the JAX package draws
both from its own PRNG, which the port does not re-implement.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --workers 4 --groups 2 --G 4 --I 2 --steps 8 --batch 4 \\
      --seq 32 --comms int8 --ckpt-dir build/ckpt --ckpt-every 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import torch

from repro_torch.checkpoint import restore, save
from repro_torch.comms import Comms
from repro_torch.configs import get_config, reduced
from repro_torch.core import (EngineConfig, HSGD, HierarchySpec,
                              all_divergences, contiguous, make_topology,
                              per_worker_grads)
from repro_torch.data import TokenStream, synth_lm_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.optim import cosine, momentum, sgd
from repro_torch.tree import tree_map


def build_argparser():
    """Flags grouped per subsystem; each subsystem group feeds one section
    of the engine's :class:`~repro_torch.core.EngineConfig` (echoed as the
    JSONL header's ``config`` line)."""
    ap = argparse.ArgumentParser(
        description="H-SGD training (repro_torch.launch.train)")

    g = ap.add_argument_group("model")
    g.add_argument("--arch", default="qwen2-0.5b")
    g.add_argument("--reduced", action="store_true",
                   help="CPU-scale same-family variant")

    g = ap.add_argument_group(
        "topology", "hierarchy shape + the aggregation rule at sync events")
    g.add_argument("--workers", type=int, default=8)
    g.add_argument("--groups", type=int, default=2)
    g.add_argument("--G", type=int, default=8)
    g.add_argument("--I", type=int, default=2)
    g.add_argument("--levels", type=str, default="",
                   help="multi-level spec 'N1,N2,..:P1,P2,..' (overrides "
                        "--workers/--groups/--G/--I)")
    g.add_argument("--aggregator", default="mean",
                   choices=["mean", "compressed", "sign"],
                   help="aggregation rule applied at every sync event")
    g.add_argument("--sync-dtype", default=None,
                   help="aggregation payload dtype override (bfloat16 "
                        "halves sync bytes; alone it implies --aggregator "
                        "compressed)")

    g = ap.add_argument_group(
        "training", "optimizer, schedule length, data shape, executor")
    g.add_argument("--backend", default="sim", choices=["sim", "mesh"],
                   help="executor (EngineConfig.executor): 'sim' (vmap "
                        "over the worker axis in one process) or 'mesh' "
                        "(one gloo process per worker on the one card, "
                        "sync events lower to collectives)")
    g.add_argument("--steps", type=int, default=50)
    g.add_argument("--batch", type=int, default=4, help="per-worker batch")
    g.add_argument("--seq", type=int, default=64)
    g.add_argument("--lr", type=float, default=3e-3)
    g.add_argument("--optimizer", default="sgd", choices=["sgd", "momentum"])
    g.add_argument("--seed", type=int, default=0)

    g = ap.add_argument_group(
        "comms", "communication plan (EngineConfig.comms)")
    g.add_argument("--comms", default=None,
                   choices=["identity", "int8", "sign", "topk"],
                   help="fuse syncs into flat per-dtype buffers and ship "
                        "them through this codec (repro_torch.comms); adds "
                        "per-level wire accounting to the telemetry.  "
                        "Default: off (the leaf-wise path)")
    g.add_argument("--comms-block", type=int, default=0,
                   help="codec block size override (int8/sign)")
    g.add_argument("--comms-rate", type=float, default=0.0,
                   help="top-k sparsification rate override (topk)")

    g = ap.add_argument_group(
        "runtime", "simulated-time heterogeneity (EngineConfig.runtime)")
    g.add_argument("--runtime", default=None,
                   help="simulated-time model 'COMPUTE[,LAT:BW,...]': "
                        "seconds per local step, then one latency:bandwidth"
                        " pair per hierarchy level outermost-first.  Adds "
                        "sim_time_s / per-level sim_sync_s to the "
                        "telemetry and a final runtime report.  "
                        "Example: --runtime 0.004,0.005:1e9,0.0003:1e10")
    g.add_argument("--straggler", default=None,
                   help="heterogeneity regime 'name[:params]': "
                        "fixed[:frac:factor] | lognormal[:sigma] | "
                        "bursty[:p_enter:p_exit:factor] (needs --runtime)")
    g.add_argument("--deadline", default=None,
                   help="deadline-elastic participation: slack seconds "
                        "('2.0') or per-level 'L1:2.0,L2:0.5' (needs "
                        "--runtime; works on both backends)")
    g.add_argument("--runtime-seed", type=int, default=0,
                   help="straggler sampler seed (draws are pure in "
                        "(seed, step))")

    g = ap.add_argument_group(
        "population",
        "sampled participation from a virtual-client population "
        "(EngineConfig.population; repro_torch.population)")
    g.add_argument("--population", default="",
                   help="declare a virtual-client population as per-level "
                        "cell fanouts 'C1xC2x...' (e.g. 1000x1000); each "
                        "sampling round (one global period G) draws the "
                        "topology's n clients, so --steps must be a "
                        "multiple of G")
    g.add_argument("--sample-k", type=int, default=0,
                   help="expected active clients per round; must equal "
                        "the topology's n")
    g.add_argument("--sample-seed", type=int, default=0,
                   help="population sampler namespace: draws are pure in "
                        "(sample-seed, round)")

    g = ap.add_argument_group(
        "observability",
        "telemetry, probes, tracing, audits (EngineConfig.metrics)")
    g.add_argument("--audit", action="store_true",
                   help="print the repro_torch.analysis collective audit of "
                        "the sync plan (per-event sync ops, wire dtypes, "
                        "payload bytes, lint findings) before training "
                        "starts")
    g.add_argument("--probes", action="store_true",
                   help="in-round observability (repro_torch.obs): "
                        "per-level parameter divergences at every sync "
                        "event (div_global/div_up_Lℓ/div_down_Lℓ in the "
                        "JSONL) and a per-step grad_norm channel; "
                        "--divergence-every is then satisfied by the "
                        "probe values")
    g.add_argument("--trace", default="",
                   help="export the run as Chrome-trace-event/Perfetto "
                        "JSON to this path")
    g.add_argument("--log-every", type=int, default=10)
    g.add_argument("--divergence-every", type=int, default=0)

    g = ap.add_argument_group("io", "checkpointing and output")
    g.add_argument("--ckpt-dir", default="")
    g.add_argument("--ckpt-every", type=int, default=0)
    g.add_argument("--out", default="")
    return ap


def make_runtime_model(args, num_levels: int):
    """--runtime 'COMPUTE[,LAT:BW,...]' (+ --straggler/--deadline/
    --runtime-seed) -> RuntimeModel, or None with the flag unset."""
    if not args.runtime:
        return None
    from repro_torch.runtime import LinkModel, RuntimeModel
    parts = [p for p in args.runtime.split(",") if p]
    links = None
    if len(parts) > 1:
        if len(parts) - 1 != num_levels:
            raise SystemExit(
                f"--runtime: got {len(parts) - 1} LAT:BW pairs for a "
                f"{num_levels}-level hierarchy (need one per level, "
                f"outermost first)")
        links = tuple(LinkModel(float(lat), float(bw))
                      for lat, bw in (p.split(":") for p in parts[1:]))
    return RuntimeModel(compute_s=float(parts[0]), links=links,
                        straggler=args.straggler, policy=args.deadline,
                        seed=args.runtime_seed)


def make_spec(args) -> HierarchySpec:
    if args.levels:
        sizes, periods = args.levels.split(":")
        return HierarchySpec(tuple(int(x) for x in sizes.split(",")),
                             tuple(int(x) for x in periods.split(",")))
    assert args.workers % args.groups == 0
    return HierarchySpec((args.groups, args.workers // args.groups),
                         (args.G, args.I))


def make_engine(args, model, spec: HierarchySpec, population=None) -> HSGD:
    """The run's engine from its flags: sgd or momentum on the cosine
    schedule, the uniform topology of ``spec``, the codec, the runtime,
    the probes and the population (a ``Population`` or None)."""
    lr = cosine(args.lr, args.steps, warmup_steps=min(10, args.steps // 10))
    opt = sgd(lr) if args.optimizer == "sgd" else momentum(lr)
    topo = make_topology(
        "uniform", spec=spec, sync_dtype=args.sync_dtype,
        aggregator=None if args.aggregator == "mean" else args.aggregator)
    comms = None
    if args.comms:
        kw = {}
        if args.comms_block:
            kw["block"] = args.comms_block
        if args.comms_rate:
            kw["rate"] = args.comms_rate
        comms = Comms(args.comms, **kw)
    runtime = make_runtime_model(args, spec.num_levels)
    return HSGD(model.loss, opt, topo, EngineConfig(
        executor=args.backend, comms=comms, runtime=runtime,
        metrics="on" if args.probes else None, population=population))


def init_params(model, seed: int, device: torch.device):
    """The run's initial params: ``model.init`` from a host generator
    seeded with ``seed``, moved to ``device``, so that a run on the card
    and one on the CPU start from the same params."""
    return model.init(torch.Generator().manual_seed(seed), device=device)


def make_stream(args, vocab: int, n_workers: int, device: torch.device):
    """``t -> batch`` with a leading worker axis (the token stream)."""
    return TokenStream(seed=args.seed, batch=args.batch, seq_len=args.seq,
                       vocab=vocab, n_workers=n_workers, device=device)


def make_client_batches(args, vocab: int, device: torch.device):
    """Population mode's ``(client_ids, t) -> batch``: each client's
    stream is keyed by its id (pure in ``(seed, t, client_id + 1)``; empty
    slots, id -1, get the reserved stream 0)."""
    def batch_fn(client_ids, t):
        bs = [synth_lm_batch(args.seed, t, args.batch, args.seq, vocab,
                             worker=int(c) + 1) for c in client_ids]
        return tree_map(lambda *xs: torch.stack(xs).to(device), *bs)
    return batch_fn


def _run_sampled(args, eng, model, cfg, spec, dev, rank: int):
    """Population-mode training loop: one sampling round per global
    period; rank 0 prints and writes."""
    G = spec.periods[0]
    server = eng.init_server_from_params(init_params(model, args.seed, dev),
                                         device=dev)
    if args.audit:
        # every rank audits (the mesh's collectives need them all)
        report = eng.population_engine().audit(
            server, config=f"{args.backend}/{args.arch}/pop")
        if rank == 0:
            print(report.summary())
    batch_fn = make_client_batches(args, cfg.vocab_size, dev)
    t0 = time.time()
    server, hist = eng.run_sampled(server, batch_fn, args.steps // G)
    elapsed = round(time.time() - t0, 2)
    log_rounds = max(1, args.log_every // G)
    history = []
    for rec in hist:
        if rec["round"] % log_rounds and rec["t"] != args.steps:
            continue
        out = {"step": rec["t"], "round": rec["round"], "loss": rec["ce"],
               "elapsed_s": elapsed, "participation": rec["participation"]}
        for key in ("sim_time_s", "dropped", "wire_bytes"):
            if key in rec:
                out[key] = rec[key]
        history.append(out)
        if rank == 0:
            print(json.dumps(out))
    if args.out and rank == 0:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)
    return history


def _mesh_rank(rank: int, argv, device: str):
    """One rank of ``--backend mesh``: :func:`main` in this rank's process
    (rank 0 prints and returns the history)."""
    return main(argv, device=device)


def main(argv=None, device: DeviceLike = "cuda"):
    """Parse ``argv`` and train on ``device`` (``"cpu"`` for tests)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = build_argparser()
    args = ap.parse_args(argv)
    # fail loudly on codec knobs that would otherwise be silently ignored
    if args.comms_block and args.comms not in ("int8", "sign"):
        ap.error(f"--comms-block only applies to --comms int8|sign "
                 f"(got --comms {args.comms})")
    if args.comms_rate and args.comms != "topk":
        ap.error(f"--comms-rate only applies to --comms topk "
                 f"(got --comms {args.comms})")
    if (args.straggler or args.deadline) and not args.runtime:
        ap.error("--straggler/--deadline need --runtime (the simulated "
                 "clock they perturb)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family == "encdec":
        # the token stream carries no encoder frames; the reference's
        # driver fails on the missing "enc_inputs" at its first step
        raise ValueError(f"launch.train: {cfg.name} is an encoder-decoder, "
                         "whose loss needs enc_inputs, and the token stream "
                         "has none (nor has the reference's driver)")
    model = build_model(cfg)
    spec = make_spec(args)
    n = spec.n_workers

    population = None
    if args.population:
        from repro_torch.population import Population
        try:
            cells = tuple(int(c) for c in
                          args.population.lower().replace("x", ",").split(",")
                          if c)
        except ValueError:
            ap.error(f"--population must be per-level cell fanouts like "
                     f"1000x1000 (got {args.population!r})")
        if len(cells) != spec.num_levels:
            ap.error(f"--population {args.population}: {len(cells)} cell "
                     f"fanouts for a {spec.num_levels}-level hierarchy "
                     f"(need one per level)")
        if args.sample_k and args.sample_k != n:
            ap.error(f"--sample-k {args.sample_k} != topology n={n}: the "
                     f"draw fills exactly one client per engine slot, so k "
                     f"is the topology's n (adjust --workers/--levels)")
        if args.steps % spec.periods[0] != 0:
            ap.error(f"--population: --steps {args.steps} must be a "
                     f"multiple of the global period G={spec.periods[0]} "
                     f"(one sampling round per global period)")
        for val, name in ((args.ckpt_dir, "--ckpt-dir"),
                          (args.trace, "--trace"),
                          (args.divergence_every, "--divergence-every")):
            if val:
                ap.error(f"{name} is not supported in population mode")
        population = Population(cells, seed=args.sample_seed)
    elif args.sample_k or args.sample_seed:
        ap.error("--sample-k/--sample-seed need --population")

    dev = resolve_device(device)
    import torch.distributed as dist
    in_mesh = dist.is_available() and dist.is_initialized()
    if args.backend == "mesh" and not in_mesh:
        from repro_torch.launch.mesh import launch
        return launch(_mesh_rank, n, backend="gloo", device=str(dev),
                      args=(argv, str(dev)))
    rank = dist.get_rank() if in_mesh else 0
    say = print if rank == 0 else (lambda *a, **k: None)

    eng = make_engine(args, model, spec, population)
    topo, comms = eng.topology, eng.comms
    from repro_torch.obs import SCHEMA_VERSION
    # JSONL header: the full engine configuration
    say(json.dumps({"schema_version": SCHEMA_VERSION,
                    "backend": args.backend, "probes": args.probes,
                    "config": eng.config.describe()}))

    if population is not None:
        return _run_sampled(args, eng, model, cfg, spec, dev, rank)

    state = eng.init_from_params(init_params(model, args.seed, dev),
                                 device=dev)
    if args.audit:
        # sync-subprogram audit only (no batch_fn): fast, and enough for
        # the sync-op, dtype and byte rules
        say(eng.audit(state, config=f"{args.backend}/{args.arch}").summary())
    if comms is not None:
        # static per-level wire accounting: what each sync event moves
        say(json.dumps({"wire": eng.wire_stats(state).summary(args.steps)}))

    stream = make_stream(args, cfg.vocab_size, n, dev)

    start = 0
    if args.ckpt_dir:
        # the checkpoint holds every worker's rows; under the mesh each
        # rank reads them all and place() keeps its own
        full = lambda x: x.expand((n,) + tuple(x.shape[1:]))
        try:
            start, tree = restore(args.ckpt_dir, {
                "params": tree_map(full, state.params),
                "opt": tree_map(full, state.opt_state)})
            # codec residuals are not checkpointed: resume restarts error
            # feedback from the fresh (zero) state
            placed = eng.executor.place(dataclasses.replace(
                state, params=tree["params"], opt_state=tree["opt"],
                step=start, comms=None))
            state = dataclasses.replace(placed, comms=state.comms)
            say(f"resumed from step {start}")
        except AssertionError:
            pass

    # telemetry cadence: the round schedule is cut at the gcd of the
    # intervals that need exact-step STATE (checkpoints, divergences), so
    # those land on round boundaries; logging reads the per-step history
    ckpt_every = args.ckpt_every if args.ckpt_dir else 0
    # with --probes the in-round probe supplies divergences at every sync
    # step, so --divergence-every needs neither the host gradient
    # recompute nor a schedule cut
    div_every = 0 if args.probes else args.divergence_every
    intervals = [v for v in (div_every, ckpt_every) if v]
    eval_every = math.gcd(*intervals) if intervals else 0
    groupings = topo.level_groupings() or {1: contiguous(n, 1)}
    t0 = time.time()

    def telemetry(st, t):
        step = t + 1
        rec = {"elapsed_s": round(time.time() - t0, 2)}
        if div_every and step % div_every == 0:
            g = per_worker_grads(model.loss, eng.mean_params(st),
                                 stream(10_000_000 + t))
            rec["divergence"] = {f"L{lvl}": all_divergences(g, gr)
                                 for lvl, gr in groupings.items()}
        if ckpt_every and step % ckpt_every == 0:
            # every rank gathers (a collective under the mesh); rank 0
            # writes
            tree = eng.executor.gather({"params": st.params,
                                        "opt": st.opt_state})
            if rank == 0:
                save(args.ckpt_dir, step, tree)
        return rec

    recorder = None
    if args.trace:
        from repro_torch.obs import TraceRecorder
        recorder = TraceRecorder()
    state, step_hist = eng.run_rounds(
        state, stream, args.steps - start,
        eval_every=eval_every, eval_fn=telemetry, trace=recorder)

    # un-hooked steps get the elapsed_s of the NEXT measured boundary: an
    # upper bound, and monotonic
    nxt = round(time.time() - t0, 2)
    for srec in reversed(step_hist):
        nxt = srec.setdefault("elapsed_s", nxt)
    history = []
    wire_cum = 0
    if args.probes:
        from repro_torch.obs import validate_record
    for srec in step_hist:
        step = srec["t"]
        wire_cum += srec.get("wire_bytes", 0)
        # log-cadence steps, the final step, and every step that carries
        # divergence telemetry (host oracle or in-round probe)
        if step % args.log_every == 0 or step == args.steps \
                or "divergence" in srec or "div_global" in srec:
            rec = {"step": step,
                   "loss": srec["ce"],
                   "lvl": spec.sync_level(step - 1),
                   "elapsed_s": srec["elapsed_s"]}
            if "grad_norm" in srec:
                rec["grad_norm"] = srec["grad_norm"]
            if comms is not None:
                rec["wire_cum_bytes"] = wire_cum
            if "sim_time_s" in srec:
                rec["sim_time_s"] = srec["sim_time_s"]
                rec["sim_sync_s"] = srec["sim_sync_s"]
            if "dropped" in srec:
                rec["dropped"] = srec["dropped"]
            rec.update({k: v for k, v in srec.items()
                        if k.startswith("div_")})
            if "divergence" in srec:
                rec["divergence"] = srec["divergence"]
            if args.probes:
                # the record is fully registered on the metrics bus: lint
                # strictly (None lvl = between syncs, skipped)
                errs = validate_record(
                    {k: v for k, v in rec.items() if v is not None},
                    strict=True)
                if errs:
                    raise SystemExit("metrics-bus violations: "
                                     + "; ".join(errs))
            history.append(rec)
            say(json.dumps(rec))
    if recorder is not None and rank == 0:
        from repro_torch.obs import validate_trace
        assert not validate_trace(recorder), validate_trace(recorder)
        recorder.save(args.trace)
        say(json.dumps({"trace": args.trace,
                        "trace_events": len(recorder.events)}))
    if eng.config.runtime is not None:
        # where the simulated time went, and the planner constants fitted
        # from the trace
        from repro_torch.core import CommModel
        fit = CommModel.fit_from_trace(step_hist, topo)
        say(json.dumps({"runtime": eng.runtime_report(),
                        "fitted_comm_model": {
                            "compute_s": round(fit.compute_s, 9),
                            "local_round_s": round(fit.local_round_s, 9),
                            "global_round_s": round(fit.global_round_s, 9),
                        }}))
    if args.out and rank == 0:
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)
    return history


if __name__ == "__main__":
    main()
