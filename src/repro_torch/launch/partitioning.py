"""Sharding rules: a tree of tensors -> a tree of partition specs, and a
spec -> DTensor placements (PyTorch counterpart of
``repro.launch.partitioning``).

Tensor parallelism ('model' axis): for each >=2-D leaf, shard the largest
dim divisible by the model-axis size (ties -> last dim).  1-D leaves
(biases, norm scales, A_log, ...) are replicated.  H-SGD training state
additionally carries a leading worker axis sharded over the replica axes
(('pod','data') multi-pod, ('data',) single-pod).  Decode caches shard
batch over the replica axes when divisible, else the cache *sequence* dim
(long_500k batch=1).

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry per
tensor dim, each None, a mesh axis name, or a tuple of names.  Every
``*_shardings`` function takes a mesh that has ``shape`` (axis name ->
size, or a tuple in ``mesh_dim_names`` order for a ``DeviceMesh``) and
axis names, so a spec needs no device and no process group;
:func:`placements` turns one into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_map

Spec = Tuple[Any, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of any mesh with
    ``axis_names`` and a ``shape`` mapping (a JAX ``AbstractMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape)


def _model_dim(shape: Tuple[int, ...], model_size: int,
               skip_axes: int = 0) -> Optional[int]:
    best, best_size = None, 0
    for i in range(skip_axes, len(shape)):
        if shape[i] % model_size == 0 and shape[i] >= best_size:
            best, best_size = i, shape[i]
    return best


def param_spec(shape: Tuple[int, ...], model_size: int,
               lead_worker: Optional[Tuple[str, ...]] = None,
               fsdp_axis: Optional[str] = None,
               fsdp_size: int = 1) -> Spec:
    """Spec for one parameter leaf.

    lead_worker: axis 0 is the H-SGD worker axis, sharded over these mesh
    axes (() => leading axis exists but replicated, the degenerate n=1 case).
    fsdp_axis: additionally shard a SECOND weight dim over this axis
    (ZeRO/FSDP within a worker — required for the >=100B archs whose full
    replica does not fit a chip's HBM, and for serving params).
    Stacked-layer leaves carry a scanned unit axis which stays unsharded.
    """
    entries: list = [None] * len(shape)
    skip = 0
    if lead_worker is not None:
        if len(lead_worker) == 1:
            entries[0] = lead_worker[0]
        elif len(lead_worker) > 1:
            entries[0] = tuple(lead_worker)
        skip = 1
    if len(shape) - skip >= 2:
        md = _model_dim(shape, model_size, skip_axes=skip)
        if md is not None and shape[md] >= model_size:
            entries[md] = "model"
            if fsdp_axis is not None:
                # secondary: largest remaining dim divisible by fsdp size
                cand = [(shape[i], i) for i in range(skip, len(shape))
                        if i != md and entries[i] is None
                        and shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size]
                if cand:
                    _, fi = max(cand)
                    entries[fi] = fsdp_axis
    return tuple(entries)


def params_shardings(mesh, param_specs: Any, *,
                     lead_worker: Optional[Tuple[str, ...]] = None,
                     fsdp_axis: Optional[str] = None,
                     model_shard: bool = True):
    axes = mesh_axes(mesh)
    model_size = axes["model"] if model_shard else 1 << 62
    fsdp_size = axes[fsdp_axis] if fsdp_axis else 1
    return tree_map(lambda leaf: param_spec(
        _shape(leaf), model_size, lead_worker=lead_worker,
        fsdp_axis=fsdp_axis, fsdp_size=fsdp_size), param_specs)


def _replica(axes: Dict[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in axes if a != "model")


def batch_shardings(mesh, batch_specs: Any,
                    lead_worker: Optional[Tuple[str, ...]] = None,
                    data_axis: Optional[str] = None):
    """Training batches (worker, local_batch, ...): worker dim over
    lead_worker axes, local batch over data_axis (fsdp mapping).
    Serving batches (batch, ...): batch over every non-model axis."""
    if lead_worker is None:
        rep = _replica(mesh_axes(mesh))
        ax0 = rep if len(rep) > 1 else rep[0]
        return tree_map(lambda leaf: (ax0,) + (None,) * (len(_shape(leaf))
                                                         - 1), batch_specs)

    ax0 = (tuple(lead_worker) if len(lead_worker) > 1
           else (lead_worker[0] if lead_worker else None))

    def one(leaf):
        nd = len(_shape(leaf))
        entries: list = [None] * nd
        entries[0] = ax0
        if data_axis is not None and nd >= 2:
            entries[1] = data_axis
        return tuple(entries)

    return tree_map(one, batch_specs)


def cache_shardings(mesh, cache_specs: Any, global_batch: int):
    """Decode caches: shard batch over replica axes when divisible; otherwise
    (long_500k, batch=1) shard the largest remaining dim (the cache sequence
    or the SSM head dim) over them; kv-heads go to 'model' when divisible.
    A leaf that is not a tensor (the cache's position) gets ``()``."""
    axes = mesh_axes(mesh)
    model_size = axes["model"]
    replica = _replica(axes)
    n_rep = math.prod(axes[a] for a in replica)
    rep_entry = replica if len(replica) > 1 else replica[0]

    def one(leaf):
        if not isinstance(leaf, torch.Tensor):
            return ()
        shape = _shape(leaf)
        nd = len(shape)
        entries: list = [None] * nd
        if nd == 0:
            return ()
        # locate batch dim: caches are (units, B, ...) or (B, ...); unit axis
        # is scanned. Heuristic: first dim equal to global_batch is batch.
        bdim = next((i for i, s in enumerate(shape) if s == global_batch), None)
        if bdim is not None and global_batch % n_rep == 0:
            entries[bdim] = rep_entry
        else:
            # shard the largest dim divisible by n_rep (cache seq for attn)
            cand = [(s, i) for i, s in enumerate(shape)
                    if i != bdim and s % n_rep == 0 and s >= n_rep]
            if cand:
                _, i = max(cand)
                entries[i] = rep_entry
        # kv heads / feature dims on 'model'
        md = None
        for i in range(nd - 1, -1, -1):
            if entries[i] is None and shape[i] % model_size == 0 \
                    and shape[i] >= model_size:
                md = i
                break
        if md is not None:
            entries[md] = "model"
        return tuple(entries)

    return tree_map(one, cache_specs)


def worker_axis_spec(rep_axes: Tuple[str, ...], ndim: int,
                     lead_axis: int = 0) -> Spec:
    """The one definition of 'the worker axis spans the replica mesh axes':
    dim ``lead_axis`` over ``rep_axes``, every other dim replicated."""
    entries: list = [None] * ndim
    entries[lead_axis] = tuple(rep_axes)
    return tuple(entries)


def hsgd_state_shardings(mesh, state: Any):
    """Specs for H-SGD training state with one worker per replica-mesh
    coordinate: every array leaf's leading worker axis spans the replica
    axes, remaining dims replicated; scalars (a 0-d leaf) replicate.  The
    worker-axis order is row-major over the replica axes (outermost
    first), the order :func:`repro_torch.core.aggregators.
    flat_worker_index` reconstructs.  The probe buffer (``HSGDState.
    metrics``) replicates: its leading dim is ring capacity, not workers,
    and its rows are identical on every worker.  ``step`` is a Python int
    in the port and gets ``()``."""
    from repro_torch.core.hsgd import HSGDState
    from repro_torch.launch.mesh import replica_axes
    rep = replica_axes(mesh)

    def one(leaf):
        nd = len(_shape(leaf))
        return () if nd == 0 else worker_axis_spec(rep, nd)

    if isinstance(state, HSGDState):
        return HSGDState(
            params=tree_map(one, state.params),
            opt_state=tree_map(one, state.opt_state), step=(),
            comms=tree_map(one, state.comms),
            metrics=tree_map(lambda _: (), state.metrics),
            pending=tree_map(one, state.pending))
    return tree_map(one, state)


def replicated(mesh, specs: Any):
    return tree_map(lambda _: (), specs)


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    for each mesh dim, ``Shard(d)`` when tensor dim ``d`` names it (alone
    or in a tuple of names, so a dim over ('pod', 'data') is sharded on
    both), ``Replicate()`` otherwise.  An axis the spec names must be a dim
    of ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is None:
                continue
            if a not in names:
                raise ValueError(f"spec {spec} names mesh axis {a!r}; the "
                                 f"mesh has {names}")
            out[names.index(a)] = Shard(d)
    return out
