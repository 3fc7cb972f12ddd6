"""H-SGD meshes over ``torch.distributed`` and a one-process-per-worker
launcher (PyTorch counterpart of ``repro.launch.mesh``).

The JAX package lays workers on a device mesh whose replica axes mirror the
hierarchy (one axis per level, level 1 outermost) and lowers a level-ℓ sync
to a collective over the axes of levels >= ℓ.  Here a worker is a process:
rank r is the worker whose row-major coordinates over ``group_sizes`` give
r, and :func:`make_hsgd_mesh` builds, for each level ℓ, the process group of
the ranks that share this rank's coordinates on the levels above ℓ — the
group of "the axes of levels >= ℓ".  :class:`MeshAxes` is such a group with
the collectives the mesh executor needs (sum, max, tiled all-gather).

Collectives cross the host.  With the ``gloo`` backend, which is the route
this package exercises, every collective copies its operand to the host,
runs there and copies the result back to the operand's device, so any
number of ranks may share one CUDA card; ``nccl`` needs a card per rank.
Each collective is one mark for the analysis layer's recorder
(:func:`repro_torch.marks.collective`), its host staging included.

:func:`launch` starts the ranks: ``launch(fn, n_workers, backend="gloo",
device="cuda", args=(...))`` spawns one process per worker, joins them in a
``file://`` store in a fresh temporary directory (no network), calls
``fn(rank, *args)`` in each and returns rank 0's return value.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import marks
from repro_torch.device import is_dtensor

# replica-axis names per hierarchy depth, level 1 (global) first; deeper
# hierarchies take generic lvl<ℓ> names
_LEVEL_AXIS_NAMES = {1: ("data",), 2: ("pod", "data"),
                     3: ("pod", "rack", "data")}


def level_axis_names(num_levels: int) -> Tuple[str, ...]:
    """Replica axis names for a ``num_levels``-deep hierarchy."""
    return _LEVEL_AXIS_NAMES.get(
        num_levels, tuple(f"lvl{l}" for l in range(1, num_levels + 1)))


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxes:
    """The mesh axes ``names`` of one rank: the process ``group`` of the
    ranks that differ from it only on those axes (``size`` of them, in
    rank order, which is row-major over the axes).  No names: the rank
    alone, and every collective is the identity."""
    names: Tuple[str, ...]
    size: int
    group: Any = None

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if not self.names:
            return t
        name = "psum" if op == dist.ReduceOp.SUM else "pmax"
        local = t.to_local() if is_dtensor(t) else t
        with marks.collective(name, self.names, local):
            if dist.get_backend(self.group) == "gloo":
                host = local.detach().to("cpu", copy=True).contiguous()
                dist.all_reduce(host, op=op, group=self.group)
                out = host.to(local.device)
            else:
                # on the tensor's own device: a meta tensor (the dry run's
                # fake world) has no host copy
                out = local.detach().clone().contiguous()
                dist.all_reduce(out, op=op, group=self.group)
        return _like(t, out)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the group, in ``t``'s dtype (int32 stays int32)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The members' ``t`` concatenated along axis 0, in rank order."""
        if not self.names:
            return t
        local = t.to_local() if is_dtensor(t) else t
        with marks.collective("all_gather", self.names, local, self.size):
            if dist.get_backend(self.group) == "gloo":
                host = local.detach().to("cpu").contiguous()
                parts = [torch.empty_like(host) for _ in range(self.size)]
                dist.all_gather(parts, host, group=self.group)
                out = torch.cat(parts, dim=0).to(local.device)
            else:
                out = local.new_empty((self.size * local.shape[0],)
                                      + tuple(local.shape[1:]))
                dist.all_gather_into_tensor(out, local.contiguous(),
                                            group=self.group)
        return _like(t, out)


def _like(t: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` as ``t`` is: a DTensor on ``t``'s mesh and placements
    when ``t`` is one (a collective over replicas leaves a worker's own
    sharding as it was), else ``local`` itself."""
    if not is_dtensor(t):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False)


class HSGDMesh:
    """This rank's view of a uniform hierarchy's mesh: its coordinates over
    ``group_sizes`` (outermost first) and one :class:`MeshAxes` per level,
    the axes of levels >= ℓ (see :func:`make_hsgd_mesh`).  ``model`` is the
    number of ranks of one worker (tensor parallelism inside it, the
    device mesh's trailing dims): rank r is worker ``r // model``."""

    def __init__(self, group_sizes: Sequence[int],
                 axis_names: Tuple[str, ...], rank: int,
                 groups: Dict[Tuple[str, ...], Any], model: int = 1):
        self.group_sizes = tuple(int(g) for g in group_sizes)
        self.axis_names = tuple(axis_names)
        self.rank = int(rank)
        self.model = int(model)
        self._groups = groups

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's worker's coordinates, row-major over
        ``group_sizes``."""
        out, r = [], self.rank // self.model
        for s in reversed(self.group_sizes):
            out.append(r % s)
            r //= s
        return tuple(reversed(out))

    def axes(self, names: Sequence[str]) -> MeshAxes:
        """The :class:`MeshAxes` of ``names``, which must be the axes of
        levels >= ℓ for some level ℓ (a suffix of ``axis_names``) or
        none."""
        names = tuple(names)
        if not names:
            return MeshAxes((), 1)
        if names not in self._groups:
            raise ValueError(
                f"mesh axes {names} are not the axes of levels >= l of "
                f"{self.axis_names} for any level l")
        size = math.prod(self.group_sizes[len(self.axis_names)
                                          - len(names):])
        return MeshAxes(names, size, self._groups[names])

    @property
    def world(self) -> MeshAxes:
        """Every replica axis: all workers (the ranks of this rank's
        'model' coordinate)."""
        return self.axes(self.axis_names)

    def __repr__(self):
        model = f", model={self.model}" if self.model > 1 else ""
        return (f"HSGDMesh({dict(zip(self.axis_names, self.group_sizes))}"
                f"{model}, rank={self.rank})")


def make_hsgd_mesh(group_sizes: Sequence[int],
                   axis_names: Optional[Sequence[str]] = None, *,
                   device_mesh=None) -> HSGDMesh:
    """The mesh of a uniform hierarchy over the initialized default process
    group, whose world must be ``prod(group_sizes)``: for each level ℓ, the
    ``new_group`` of the ranks that share this rank's coordinates on the
    levels above ℓ.  Every rank must call it, and every rank creates every
    group in the same order (``new_group`` is collective).  For a
    ``GroupedTopology`` pass ``(n_workers,)``: its events lower over all
    ranks.

    ``device_mesh``: a ``DeviceMesh`` whose leading dims are the replica
    dims, their product ``prod(group_sizes)``, and whose other dims (its
    'model' dim; for the dry run's fsdp mapping its 'data' dim too) hold
    the ranks of one worker.  The world is then ``prod(group_sizes)`` x
    those ranks, the levels factor the replica dims in order (outermost
    first), and a level's group also shares this rank's coordinates on
    the worker's dims.  Axis names default to the replica dims' where the
    levels are those dims, else to ``<dim><j>`` for the j-th level inside a
    dim (``data0``, ``data1`` for (4, 4) over 'data'), and ``lvl<l>`` for a
    level of one worker that spans no dim."""
    gs = tuple(int(g) for g in group_sizes)
    model = 1
    if device_mesh is not None:
        dims = list(zip(device_mesh.mesh_dim_names, device_mesh.shape))
        k, acc = 0, 1
        while acc < math.prod(gs) and k < len(dims):
            acc *= dims[k][1]
            k += 1
        if acc != math.prod(gs):
            raise ValueError(f"the levels {gs} are not the leading dims of "
                             f"the device mesh {dict(dims)}")
        model = math.prod(size for _, size in dims[k:])
        if axis_names is None:
            axis_names = _level_names(gs, dict(dims[:k]))
    names = tuple(axis_names) if axis_names else level_axis_names(len(gs))
    if len(names) != len(gs):
        raise ValueError(f"{len(names)} axis names {names} for "
                         f"{len(gs)} levels {gs}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_hsgd_mesh needs an initialized default process group: "
            "run under repro_torch.launch.mesh.launch (one process per "
            "worker) or call torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(gs) * model:
        per = f" x {model} ranks" if model > 1 else ""
        raise ValueError(f"a mesh of {gs} needs a world of "
                         f"{math.prod(gs) * model} processes, one per "
                         f"worker{per}; this world has {world}")
    groups: Dict[Tuple[str, ...], Any] = {}
    for level in range(1, len(gs) + 1):
        members = math.prod(gs[level - 1:])
        for start in range(0, world // model, members):
            for m in range(model):
                ranks = [w * model + m for w in range(start, start + members)]
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[names[level - 1:]] = group
    return HSGDMesh(gs, names, rank, groups, model)


def _level_names(gs: Tuple[int, ...],
                 dims: Dict[str, int]) -> Tuple[str, ...]:
    """A name per level of ``gs``, the levels factoring the replica
    ``dims`` in order: a dim's name where one level is the whole dim,
    ``<dim><j>`` for the j-th of several levels inside it, ``lvl<l>`` for
    a trailing level of one worker."""
    names, levels = [], list(gs)
    for dim, size in dims.items():
        taken = 0
        while size > 1:
            if not levels or size % levels[0]:
                raise ValueError(f"the levels {gs} do not factor the "
                                 f"replica dims {dims} in order")
            size //= levels.pop(0)
            taken += 1
        names += [dim] if taken == 1 else [f"{dim}{j}" for j in range(taken)]
    for size in levels:
        if size != 1:
            raise ValueError(f"the levels {gs} do not factor the replica "
                             f"dims {dims} in order")
        names.append(f"lvl{len(names) + 1}")
    return tuple(names)


def make_production_mesh(multi_pod: bool = False, device_type: str = "cpu"):
    """The production ``DeviceMesh`` over the initialized default group:
    256 ranks as (data=16, model=16), or 512 as (pod=2, data=16,
    model=16): 'pod' carries H-SGD's global aggregation (the slow fabric
    between nodes), 'data' the local ones, 'model' tensor parallelism
    inside a worker.  The default group must have exactly that many ranks
    (the dry run's fake world, :mod:`repro_torch.launch.dryrun`); this
    never creates one.  ``device_type`` "cpu" places tensors of the CPU
    and of the meta device, "cuda" those of the card.  Each dim's group is
    named to the recorder (:func:`repro_torch.marks.name_groups`), so that
    the cost model prices torch's functional collectives by their dims."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialized "
                           f"default process group of {math.prod(shape)} "
                           "ranks")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs a world of {math.prod(shape)} ranks; this "
                         f"world has {dist.get_world_size()}")
    return name_mesh_groups(init_device_mesh(device_type, shape,
                                             mesh_dim_names=axes))


def name_mesh_groups(device_mesh):
    """Name each dim's process group of ``device_mesh`` to the recorder;
    returns the mesh."""
    marks.name_groups({device_mesh.get_group(a).group_name: (a,)
                       for a in device_mesh.mesh_dim_names})
    return device_mesh


def replica_axes(mesh) -> tuple:
    """Mesh axes carrying H-SGD worker replicas (everything but 'model');
    ``mesh`` a ``DeviceMesh`` or any mesh with ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(a for a in names if a != "model")


def n_replicas(mesh) -> int:
    from repro_torch.launch.partitioning import mesh_axes
    axes = mesh_axes(mesh)
    return math.prod(axes[a] for a in replica_axes(mesh))


def _rank_main(fn, rank: int, n_workers: int, backend: str, device: str,
               store: str, args: tuple, results, timeout: float) -> None:
    """One rank: join the store, call ``fn(rank, *args)``, report."""
    try:
        # the ranks of one launch share this host: keep gloo on loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_workers))
        if torch.device(device).type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: device {device!r} was "
                                   "asked for and this process sees no "
                                   "CUDA card")
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=store, world_size=n_workers, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        # by value: torch's queue reducer would share tensors through file
        # descriptors that die with this process
        results.put(("ok", rank, pickle.dumps(out if rank == 0 else None)))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        raise


def launch(fn: Callable[..., Any], n_workers: int, *, backend: str = "gloo",
           device: str = "cuda", args: tuple = (),
           timeout: float = 600.0) -> Any:
    """Run ``fn(rank, *args)`` in ``n_workers`` spawned processes, one per
    worker, in one ``torch.distributed`` world; returns rank 0's return
    value.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function); the
    ranks import ``fn``'s module.  ``device="cuda"`` sets each rank's
    current card to ``rank % device_count()`` and makes a rank without a
    card fail; with ``backend="gloo"`` all ranks may share one card.  The
    ranks join a ``file://`` store in a fresh temporary directory.  If any
    rank raises or dies, or the ranks do not all finish within ``timeout``
    seconds, the others are terminated and this raises, with the failed
    rank's traceback."""
    n_workers = int(n_workers)
    if n_workers < 1:
        raise ValueError(f"launch: n_workers must be >= 1, got {n_workers}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"launch: backend must be 'gloo' or 'nccl', got "
                         f"{backend!r}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"launch: device {device!r} was asked for but "
                           "torch.cuda.is_available() is False")
    if backend == "nccl":
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if dev.type != "cuda" or n_workers > cards:
            raise ValueError(
                f"launch: nccl needs one CUDA card per rank and refuses two "
                f"ranks on one card: {n_workers} ranks, {cards} cards on "
                f"device {device!r}; use backend='gloo' to share a card")
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="hsgd-mesh-") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n_workers, backend, device, store,
                                   tuple(args), results, float(timeout)))
                 for r in range(n_workers)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, float(timeout))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()


def _collect(procs, results, timeout: float) -> Any:
    """Wait for every rank's report; raise on the first failure."""
    deadline = time.monotonic() + timeout
    done, out = set(), None
    while len(done) < len(procs):
        try:
            kind, rank, payload = results.get(timeout=0.2)
        except queue.Empty:
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if r not in done and p.exitcode not in (None, 0)]
            if dead:
                # a rank that failed reports before it exits: give its
                # traceback a moment to arrive
                try:
                    kind, rank, payload = results.get(timeout=5.0)
                except queue.Empty:
                    r, code = dead[0]
                    raise RuntimeError(f"launch: rank {r} died with exit "
                                       f"code {code}") from None
            elif time.monotonic() > deadline:
                missing = sorted(set(range(len(procs))) - done)
                raise TimeoutError(f"launch: ranks {missing} did not finish "
                                   f"within {timeout} s")
            else:
                continue
        if kind == "error":
            # a failed rank's peers fail in their next collective, possibly
            # first: report every failure that arrives within a moment
            errors = [(rank, payload)]
            grace = time.monotonic() + 2.0
            while time.monotonic() < grace:
                try:
                    kind, rank, payload = results.get(timeout=0.2)
                except queue.Empty:
                    continue
                if kind == "error":
                    errors.append((rank, payload))
            raise RuntimeError("\n".join(
                f"launch: rank {r} failed:\n{tb}" for r, tb in errors))
        done.add(rank)
        if rank == 0:
            out = pickle.loads(payload)
    return out
