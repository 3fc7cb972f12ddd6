"""Multi-pod dry run: record and price rank 0's program of every (arch x
input shape x mesh) (PyTorch counterpart of ``repro.launch.dryrun``).

The reference lowers each pair under GSPMD on 512 fake host devices and
prices the compiled HLO per chip.  An eager program has no HLO and one
process runs one rank, so the port records **rank 0's program**: the
default process group is torch's fake one (every collective returns at
once, without data) of 256 or 512 ranks, the production ``DeviceMesh``
lies over it, and every tensor is a DTensor placed by
:mod:`repro_torch.launch.partitioning` whose local shard is a ``meta``
tensor (shape and dtype, no memory, no arithmetic).  One call of the
program runs under the analysis layer's recorder, which keeps the ops
rank 0 runs on its shards (the local ops of each DTensor op, and the
functional collectives of its redistributions), and
:mod:`repro_torch.roofline` prices them per card.

Training runs the H-SGD engine's mesh lowering: ``MeshExecutor`` over an
``HSGDMesh`` of the device mesh's replica dims, so a level-ℓ sync is an
all-reduce of rank 0's shards over the ranks that hold the same shards in
the workers of its level-ℓ group, and 'model' tensor parallelism
composes inside a worker (the sim's in-array means cannot run on a
worker axis that is sharded: DTensor refuses to reshape a sharded dim).
Serving runs ``prefill`` and ``decode_step`` with params placed over
('data', 'model') and the batch over the replica axes, as the
reference's.  Kernels are off (the reference's default); the card's
phase (``chip_smoke.py::dryrun_phase``) turns them on and materializes
rank 0's shards on the card.

    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k

writes ``build/dryrun_torch.json`` (the reference's record format), which
``repro_torch.experiments.roofline_table`` renders.  ``peak_memory_bytes``
is None on ``meta``; each record carries ``rank0_resident_bytes``, the
bytes of rank 0's local state and batch shards, which the table's
``fits_hbm`` reads in its place.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import marks
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import (HSGD, EngineConfig, HierarchySpec,
                              MeshExecutor, SyncEvent, make_topology)
from repro_torch.device import is_dtensor
from repro_torch.launch.mesh import (make_hsgd_mesh, make_production_mesh,
                                     n_replicas, replica_axes)
from repro_torch.launch.partitioning import (batch_shardings,
                                             cache_shardings, mesh_axes,
                                             param_spec, params_shardings,
                                             placements)
from repro_torch.models.layers import token_first
from repro_torch.models.model import (build_model, decode_state_specs,
                                      input_specs, param_specs,
                                      train_batch_specs)
from repro_torch.optim import sgd
from repro_torch.roofline import (RooflineReport, analyze_program,
                                  combine_train_steps)
from repro_torch.roofline.analysis import model_flops_per_step
from repro_torch.tree import tree_leaves, tree_map

# H-SGD periods used for the production roofline (representative of the
# paper's CIFAR sweet spot G=50, I=5 scaled to round powers of two)
HSGD_G, HSGD_I = 64, 8

# long_500k only for sub-quadratic archs (see DESIGN.md shape-skip table)
LONG_OK = {"gemma3-12b", "recurrentgemma-2b", "mamba2-130m", "mixtral-8x22b"}

DEFAULT_OUT = "build/dryrun_torch.json"


def applicable(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch in LONG_OK
    return True


REPLICA_HBM_BUDGET = 8e9  # bytes/chip for one worker's param shard


def train_plan(cfg: ModelConfig, mesh) -> Dict:
    """Choose the H-SGD worker<->mesh mapping by replica memory.

    'replica' (default): every (pod, data) index is a worker — n=32 full
      replicas (multi-pod), params sharded only on 'model' within a worker.
    'fsdp': for archs whose replica does not fit HBM at n=replica density
      (nemotron-340b, mixtral-8x22b): workers = pods only (n=2), the 'data'
      axis becomes intra-worker batch parallelism + FSDP param sharding.
      Single-pod fsdp degenerates to n=1 (H-SGD needs >=2 pods at this
      scale — recorded in DESIGN.md).
    """
    axes = mesh_axes(mesh)
    n_chips = math.prod(axes.values())
    multi = "pod" in axes
    n_dense = axes["pod"] * axes["data"] if multi else axes["data"]
    bytes_per_param = 2 if cfg.param_dtype == "bfloat16" else 4
    per_chip_dense = cfg.param_count() * bytes_per_param * n_dense / n_chips
    if per_chip_dense <= REPLICA_HBM_BUDGET:
        if multi:
            spec = HierarchySpec((axes["pod"], axes["data"]),
                                 (HSGD_G, HSGD_I))
            lead = ("pod", "data")
        else:
            d = axes["data"]
            spec = HierarchySpec((4, d // 4), (HSGD_G, HSGD_I))
            lead = ("data",)
        return {"mapping": "replica", "spec": spec, "lead": lead,
                "fsdp_axis": None, "data_axis": None}
    if multi:
        spec = HierarchySpec((axes["pod"],), (HSGD_G,))
        lead = ("pod",)
    else:
        spec = HierarchySpec((1,), (HSGD_G,))
        lead = ()
    return {"mapping": "fsdp", "spec": spec, "lead": lead,
            "fsdp_axis": "data", "data_axis": "data"}


def model_flops_per_chip(cfg: ModelConfig, shape: InputShape, mesh) -> float:
    return model_flops_per_step(cfg, shape) / math.prod(
        mesh_axes(mesh).values())


# ---------------------------------------------------------------------------
# the fake world and placement
# ---------------------------------------------------------------------------
def _teach_squeeze_dims() -> None:
    """Give DTensor a rule for ``aten.squeeze.dims`` where it has none
    (torch 2.11; autograd's backward of a broadcast emits it): one
    ``squeeze.dim`` per squeezed dim, which DTensor does have.  Newer
    torch has its own rule and is left alone."""
    from torch.distributed.tensor import DTensor
    aten = torch.ops.aten
    dispatcher = DTensor._op_dispatcher
    prop = dispatcher.sharding_propagator
    if any(aten.squeeze.dims in getattr(prop, registry, {})
           for registry in ("op_strategy_funcs", "op_to_rules",
                            "op_single_dim_strategy_funcs")):
        return

    def squeeze_dims(op_call, args, kwargs):
        x, dims = args[0], args[1]
        for d in sorted((d % x.ndim for d in dims), reverse=True):
            if x.shape[d] == 1:
                x = aten.squeeze.dim(x, d)
        return x
    dispatcher._custom_op_handlers[aten.squeeze.dims] = squeeze_dims


@contextlib.contextmanager
def fake_world(world_size: int):
    """torch's fake default process group of ``world_size`` ranks, this
    process rank 0: every collective returns at once without moving data.
    Torn down on the way out, whatever happens inside, so that
    ``dist.is_initialized()`` is False again after it."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group is already "
                           "initialized")
    _teach_squeeze_dims()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        marks.forget_groups()


def _row(spec: Tuple) -> Tuple:
    """A worker's row of a spec with a leading worker axis: that axis is
    the process's own, so it is not placed."""
    return (None,) + tuple(spec[1:])


def place(t: torch.Tensor, spec: Tuple, mesh):
    """``t`` as a DTensor on ``mesh`` with ``spec``'s placements: rank 0's
    shard of it (for a ``meta`` ``t``, a ``meta`` shard)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh))


def _place_tree(tree, specs_of: Callable[[torch.Tensor], Tuple], mesh):
    return tree_map(lambda t: place(t, specs_of(t), mesh)
                    if isinstance(t, torch.Tensor) else t, tree)


def local_bytes(tree) -> int:
    """Bytes of rank 0's shards of the tensors in ``tree``."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if is_dtensor(t) else t
            total += local.numel() * local.element_size()
    return total


def rank0_shards(placed, full):
    """``placed`` (DTensors whose shards are ``meta``) with rank 0's shards
    taken from the global tensors ``full`` (same tree), on ``full``'s
    device.  Rank 0 sits at coordinate 0 of every mesh dim, so its shard of
    every dim starts at index 0."""
    from torch.distributed.tensor import DTensor

    def one(d, f):
        if not is_dtensor(d):
            return f
        local = f[tuple(slice(0, n) for n in d.to_local().shape)]
        return DTensor.from_local(local.contiguous(), d.device_mesh,
                                  d.placements, shape=d.shape,
                                  stride=d.stride(), run_check=False)
    return tree_map(one, placed, full)


def rank0_fill(placed, fill: Callable[[torch.Tensor], torch.Tensor]):
    """``placed`` with each ``meta`` shard replaced by ``fill(shard)`` (a
    tensor of its shape and dtype)."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda d: DTensor.from_local(
        fill(d.to_local()), d.device_mesh, d.placements, shape=d.shape,
        stride=d.stride(), run_check=False) if is_dtensor(d) else d, placed)


def _replicating(fn: Callable) -> Callable:
    """``fn`` with plain tensors taken as replicated DTensors (the model's
    own constants: positions, masks, RoPE's frequencies)."""
    from torch.distributed.tensor.experimental import implicit_replication

    def call(*args, **kwargs):
        with implicit_replication():
            return fn(*args, **kwargs)
    return call


@dataclasses.dataclass
class Program:
    """One program of rank 0: ``fn(*args)``, and the bytes of rank 0's
    local state and batch shards it reads."""
    fn: Callable
    args: Tuple
    resident_bytes: int


# ---------------------------------------------------------------------------
# rank 0's programs per shape kind
# ---------------------------------------------------------------------------
def train_programs(cfg: ModelConfig, shape: InputShape, mesh,
                   kinds=("local", "local_sync", "global_sync"), *,
                   sync_dtype: str = "float32",
                   model_shard: bool = True,
                   seq_axis: Optional[str] = None,
                   accum_steps: int = 1,
                   levels: int = 2) -> Tuple[Dict[str, Program], Dict]:
    """Rank 0's H-SGD step of each kind on ``meta`` shards, and the plan.

    sync_dtype / model_shard / seq_axis / accum_steps are §Perf hillclimb
    knobs: bf16 aggregation payloads, DP-only parameter layout (replicate
    weights within a worker), sequence sharding of the batch over an axis,
    and microbatch gradient accumulation.  levels=3 records a THREE-level
    hierarchy (Algorithm D.1) on the multi-pod mesh: pods / data-quadrants
    / workers with nested periods (G, G/4, I)."""
    model = build_model(cfg)
    plan = train_plan(cfg, mesh)
    axes = mesh_axes(mesh)
    if levels == 3:
        if plan["mapping"] != "replica" or "pod" not in axes:
            raise ValueError("the 3-level demo needs the replica mapping on "
                             "the multi-pod mesh")
        d = axes["data"]
        plan["spec"] = HierarchySpec((axes["pod"], 4, d // 4),
                                     (HSGD_G, HSGD_G // 4, HSGD_I))
    spec: HierarchySpec = plan["spec"]
    lead = plan["lead"]
    topo = make_topology("uniform", spec=spec, sync_dtype=sync_dtype)
    hmesh = make_hsgd_mesh(spec.group_sizes, device_mesh=mesh)
    eng = HSGD(model.loss, sgd(1e-3), topo,
               EngineConfig(executor=MeshExecutor(hmesh),
                            accum_steps=accum_steps))

    # rank 0's rows, placed on the dims inside its worker
    inner = tuple(a for a in mesh.mesh_dim_names if a not in lead)
    wmesh = mesh[inner] if len(inner) < len(axes) else mesh
    state = eng.init_from_params(param_specs(model), device="meta")
    model_size = axes["model"] if model_shard else 1 << 62
    fsdp = plan["fsdp_axis"]

    def state_spec(t):
        return _row(param_spec(tuple(t.shape), model_size, lead_worker=lead,
                               fsdp_axis=fsdp,
                               fsdp_size=axes[fsdp] if fsdp else 1))
    state = dataclasses.replace(
        state, params=_place_tree(state.params, state_spec, wmesh),
        opt_state=_place_tree(state.opt_state, state_spec, wmesh))

    n = spec.n_workers
    batch = tree_map(lambda t: torch.empty(
        (1, shape.global_batch // n) + tuple(t.shape[1:]), dtype=t.dtype,
        device="meta"), train_batch_specs(cfg, shape))

    def batch_spec(t):
        s = list(_row(batch_shardings(mesh, [t], lead_worker=lead,
                                      data_axis=plan["data_axis"])[0]))
        if seq_axis is not None:
            s = (s + [None] * 3)[:3]
            s[2] = seq_axis
        return tuple(s)
    batch = _place_tree(batch, batch_spec, wmesh)

    # M=1 hierarchies (fsdp mapping) have no distinct local sync
    kind_map = {"local": None, "global_sync": SyncEvent(level=1)}
    if spec.num_levels >= 2:
        kind_map["local_sync"] = SyncEvent(level=spec.num_levels)
    if spec.num_levels >= 3:
        kind_map["mid_sync"] = SyncEvent(level=2)
    resident = local_bytes((state.params, state.opt_state, batch))

    def program(step):
        fn = _replicating(_pinned(step))
        if seq_axis is None:
            return fn

        def by_sequence(*args):
            with token_first():
                return fn(*args)
        return by_sequence
    out = {k: Program(program(eng.step_fn(kind_map[k])), (state, batch),
                      resident)
           for k in kinds if k in kind_map}
    return out, plan


def _pinned(step: Callable) -> Callable:
    """``step`` with its new params and optimizer state put back on the
    placements of the state it was given, as the reference's jit pins
    ``out_shardings`` to the state's shardings: DTensor's add takes the
    update's placement where it differs from the param's (a replicated
    norm scale comes back sharded like its gradient)."""
    def pin(new, old):
        if not is_dtensor(new) or new.placements == old.placements:
            return new
        return new.redistribute(old.device_mesh, old.placements)

    def run(state, batch):
        new, metrics = step(state, batch)
        return dataclasses.replace(
            new, params=tree_map(pin, new.params, state.params),
            opt_state=tree_map(pin, new.opt_state, state.opt_state)), metrics
    return run


def _serving_params(model, mesh):
    return _place_tree(param_specs(model), lambda t: params_shardings(
        mesh, [t], fsdp_axis="data")[0], mesh)


def prefill_program(cfg: ModelConfig, shape: InputShape, mesh,
                    seed: Optional[int] = None) -> Program:
    """Rank 0's ``prefill`` of ``shape``'s batch: params over ('data',
    'model'), tokens over the replica axes.  ``seed`` None: ``meta``
    shards; else rank 0's shards on the mesh's device, the params' from a
    full ``model.init`` drawn from ``seed`` and the tokens uniform."""
    model = build_model(cfg)
    params = _serving_params(model, mesh)
    specs = input_specs(cfg, shape)
    batch = {k: place(t, batch_shardings(mesh, [t])[0], mesh)
             for k, t in specs.items()}
    if seed is not None:
        params, batch = _materialize(model, mesh, params, batch, seed)
    if cfg.family == "encdec":
        def prefill(p, b):
            return model.prefill(p, b["tokens"], max_len=shape.seq_len,
                                 enc_inputs=b["enc_inputs"])
    else:
        def prefill(p, b):
            return model.prefill(p, b["tokens"], max_len=shape.seq_len)
    return Program(_replicating(prefill), (params, batch),
                   local_bytes((params, batch)))


def decode_program(cfg: ModelConfig, shape: InputShape, mesh,
                   seed: Optional[int] = None) -> Program:
    """Rank 0's ``decode_step`` against a ``shape.seq_len`` cache: the
    cache placed by :func:`cache_shardings`, the token over the replica
    axes when they divide the batch.  ``seed`` as in
    :func:`prefill_program` (the cache's shards are zeros)."""
    model = build_model(cfg)
    params = _serving_params(model, mesh)
    specs = decode_state_specs(cfg, shape)
    cache = _place_tree(specs["cache"], lambda t: cache_shardings(
        mesh, [t], shape.global_batch)[0], mesh)
    rep = replica_axes(mesh)
    tok_spec = (rep if len(rep) > 1 else rep[0],) \
        if shape.global_batch % n_replicas(mesh) == 0 else (None,)
    batch = {"cache": cache, "token": place(specs["token"], tok_spec, mesh)}
    if seed is not None:
        params, batch = _materialize(model, mesh, params, batch, seed)
    return Program(_replicating(lambda p, b: model.decode_step(
        p, b["cache"], b["token"])), (params, batch),
        local_bytes((params, batch)))


def _materialize(model, mesh, params, batch, seed: int):
    """Rank 0's shards of params and batch on the mesh's device: the
    params' from a full ``model.init`` (seed), the batch's token ids
    uniform, its floats standard normal, the cache's zeros."""
    device = torch.device(mesh.device_type)
    gen = torch.Generator(device=device).manual_seed(seed)
    full = model.init(gen, device=device)
    params = rank0_shards(params, full)
    del full

    def fill(t):
        if not t.dtype.is_floating_point:
            return torch.randint(0, model.cfg.vocab_size, t.shape,
                                 generator=gen, device=device,
                                 dtype=t.dtype)
        return torch.randn(t.shape, generator=gen, device=device).to(t.dtype)

    cache = batch.get("cache")
    rest = {k: v for k, v in batch.items() if k != "cache"}
    out = rank0_fill(rest, fill)
    if cache is not None:
        out["cache"] = rank0_fill(cache, lambda t: torch.zeros(
            t.shape, dtype=t.dtype, device=device))
    return params, out


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------
def warm_up(program: Program) -> None:
    """One unrecorded call of ``program`` on copies of its arguments:
    DTensor works out and caches the index maps of some redistributions
    on its first call (small int64 host ops and host reads), so a
    recording after it sees the steady program, as the reference compiles
    before it prices."""
    program.fn(*copy.deepcopy(program.args))


def price(name: str, program: Program, mesh, model_flops: float,
          top_axis: str = "pod", warm: bool = True) -> RooflineReport:
    """One recorded call of ``program`` priced per card, after
    :func:`warm_up` unless ``warm`` is False (a program of the same
    shapes has run); collectives over ``top_axis`` are cross-node (the
    reference's ``pod_size=256``)."""
    if warm:
        warm_up(program)
    return analyze_program(name, program.fn, *program.args,
                           top_axis=top_axis, model_flops=model_flops)


def record_train(cfg: ModelConfig, shape: InputShape, mesh,
                 kinds=("local", "local_sync", "global_sync"),
                 **knobs) -> Dict[str, Any]:
    """Each step kind's report of rank 0's training program (see
    :func:`train_programs` for ``knobs``), the plan under ``"_plan"``,
    rank 0's resident bytes under ``"_resident"`` and those of its params
    alone under ``"_params"``."""
    programs, plan = train_programs(cfg, shape, mesh, kinds, **knobs)
    mf = model_flops_per_chip(cfg, shape, mesh)
    # one warm-up serves every step kind: they share the local update
    out: Dict[str, Any] = {k: price(f"{cfg.name}/{shape.name}/{k}", p, mesh,
                                    mf, warm=i == 0)
                           for i, (k, p) in enumerate(programs.items())}
    out["_plan"] = plan
    first = next(iter(programs.values()))
    out["_resident"] = first.resident_bytes
    out["_params"] = local_bytes(first.args[0].params)
    return out


def record_prefill(cfg: ModelConfig, shape: InputShape,
                   mesh) -> Dict[str, Any]:
    p = prefill_program(cfg, shape, mesh)
    return {"prefill": price(f"{cfg.name}/{shape.name}/prefill", p, mesh,
                             model_flops_per_chip(cfg, shape, mesh)),
            "_resident": p.resident_bytes}


def record_decode(cfg: ModelConfig, shape: InputShape,
                  mesh) -> Dict[str, Any]:
    p = decode_program(cfg, shape, mesh)
    return {"decode": price(f"{cfg.name}/{shape.name}/decode", p, mesh,
                            model_flops_per_chip(cfg, shape, mesh)),
            "_resident": p.resident_bytes}


RECORDERS = {"train": record_train, "prefill": record_prefill,
             "decode": record_decode}


def make_record(arch: str, shape: InputShape, multi_pod: bool,
                recorded: Dict[str, Any], record_s: float,
                n_chips: int) -> Dict:
    """The reference's record (``dryrun.py:250-270``) of one pair's
    reports, with ``rank0_resident_bytes``."""
    recorded = dict(recorded)
    plan = recorded.pop("_plan", None)
    resident = recorded.pop("_resident")
    recorded.pop("_params", None)
    reports: Dict[str, RooflineReport] = recorded
    cfg = get_config(arch)
    rec = {
        "arch": arch, "shape": shape.name, "multi_pod": multi_pod,
        "lower_s": record_s,
        "mapping": None if plan is None else plan["mapping"],
        "n_workers": None if plan is None else plan["spec"].n_workers,
        "steps": {k: r.asdict() for k, r in reports.items()},
        "rank0_resident_bytes": resident,
    }
    if shape.kind == "train":
        rec["amortized"] = combine_train_steps(reports, HSGD_G, HSGD_I)
    # headline report: global_sync for train (worst step), else the only step
    head = reports.get("global_sync") or next(iter(reports.values()))
    rec["dominant"] = head.dominant
    rec["terms_s"] = {"compute": head.compute_s, "memory": head.memory_s,
                      "collective": head.collective_s}
    model_flops = model_flops_per_step(cfg, shape)
    rec["model_flops_per_chip"] = model_flops / n_chips
    rec["useful_ratio"] = (model_flops / n_chips) / max(head.flops_per_chip,
                                                        1)
    return rec


def run_pair(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True) -> Dict:
    """Record one pair in its own fake world and return its record."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh = make_production_mesh(multi_pod)
        t0 = time.time()
        recorded = RECORDERS[shape.kind](cfg, shape, mesh)
        t_record = time.time() - t0
    if verbose:
        for k, rep in recorded.items():
            if k.startswith("_"):
                continue
            print(f"  [{k}] flops/chip {rep.flops_per_chip:.3e}  "
                  f"bytes/chip {rep.bytes_per_chip:.3e}  "
                  f"coll intra {rep.coll_intra:.3e} "
                  f"cross {rep.coll_cross:.3e}", flush=True)
    return make_record(arch, shape, multi_pod, recorded, t_record, world)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from repro_torch.experiments import roofline_table
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == roofline_table.REFERENCE_FILE:
        ap.error(f"--out {args.out}: {roofline_table.REFERENCE_FILE} is the "
                 f"JAX package's dry-run cache; the port writes its own "
                 f"({DEFAULT_OUT})")

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results: Dict = {}
    if os.path.exists(args.out) and not args.force:
        results = roofline_table.load(args.out)

    failures = []
    for arch in archs:
        for shape in shapes:
            if not applicable(arch, shape):
                continue
            for mp in meshes:
                key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
                if key in results and not args.force:
                    print(f"skip (cached): {key}")
                    continue
                print(f"=== {key}", flush=True)
                try:
                    results[key] = run_pair(arch, shape, mp)
                    roofline_table.save(results, args.out)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((key, str(e)))
    print(f"\ndone: {len(results)} cached results, {len(failures)} failures")
    for k, e in failures:
        print(" FAIL", k, e[:200])
    if failures:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
