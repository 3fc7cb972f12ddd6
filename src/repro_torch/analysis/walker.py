"""The recorder: what one eager call ships (PyTorch counterpart of
``repro.analysis.walker``).

The reference walks a jaxpr.  An eager program has none and is only seen
by running it, so the recorder runs ONE call under a
``TorchDispatchMode`` and keeps the aten ops that matter for sync-plan
auditing, as the same plain data (:class:`JaxprSummary` of
:class:`OpRecord`, the reference's field names):

* **collectives** — one record per ``MeshAxes`` call (``psum``, ``pmax``,
  ``all_gather``; :func:`repro_torch.marks.collective`) with its axis
  names and its operand's dtype, elements and bytes.  These ARE the wire
  under the mesh executor.  Under ``gloo`` each stages its operand through
  the host; the staging is the collective's and is not recorded again.
  torch's functional collectives (``_c10d_functional.all_reduce``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single``: a DTensor's redistributions) are recorded the
  same way, over the mesh axes their group spans
  (:func:`repro_torch.marks.group_axes`).
* **reduces** — ``aten.sum``/``aten.mean`` of every overload and the
  products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``), the
  counterparts of ``reduce_sum``/``dot_general``; ``amax``/``amin`` are not
  reduces, as ``reduce_max`` is not one in the reference.  An aggregation
  that the port sums member after member to take XLA's order is one
  reduce (:func:`repro_torch.marks.reduce`), its adds unrecorded.
* **kernels** — the hand-written kernels' wrapper calls
  (:func:`repro_torch.marks.kernel`), by name.  Nothing inside one is
  recorded: on the card its work is invisible to the dispatcher, and on
  the CPU the plain version's reduces are the kernel's arithmetic, as the
  reference drops what sits under a ``pallas_call``.  So a call records
  the same on the card as on the CPU.
* **callbacks** — host reads of device values: ``_local_scalar_dense``
  (``.item()``, ``float(t)``, ``bool(t)``), ``.tolist()``, ``.numpy()``,
  printing a tensor, and the ops whose output shape depends on the data
  (``nonzero``, ``masked_select``, ``unique``, boolean indexing,
  ``repeat_interleave`` of a tensor without its output size).
* **transfers** — copies that change device, and tensors built from host
  data (``aten.lift_fresh``): see rule R3 (:mod:`.rules`).
* **ops** — for the cost model (:mod:`repro_torch.roofline`), every op as
  :class:`OpShapes`: each aten op outside the kernel, collective and host
  read regions with its operands' and results' dtypes and shapes (the
  adds inside a marked reduce too: they are what runs), each kernel
  region with its work, each collective with its operand, its result and
  its axes.

An op on DTensors is not recorded as such: the mode lets the DTensor
unwrap, and records the ops it then runs on its local shards (its
redistributions' collectives, then the op itself), at the shapes one rank
holds, so a recorded call is one rank's program.  The ops DTensor runs on
fake tensors to propagate shardings are not recorded.

Autograd's backward runs on a device thread on the card; the dispatch mode
travels with autograd's thread-local state, so those ops are recorded too.
A callback's or transfer's ``path`` is the innermost call site outside
torch (``file:line``); every other record's is the enclosing marks.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import sys
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode)
from torch.utils._pytree import tree_leaves as _pytree_leaves

from repro_torch import marks

# torch's functional collectives, by their aten names
FUNCTIONAL_COLLECTIVES = frozenset({"all_reduce", "all_gather_into_tensor",
                                    "reduce_scatter_tensor",
                                    "all_to_all_single"})
COLLECTIVE_PRIMS = frozenset({"psum", "pmax", "all_gather"}) \
    | FUNCTIONAL_COLLECTIVES
REDUCE_PRIMS = frozenset({"sum", "mean", "mm", "addmm", "bmm", "baddbmm",
                          "mv", "dot", "member_sum", "sum_in"})
# host reads: the aten ops, then the Tensor methods the recorder wraps
# (they read memory in C++ or disable dispatch modes, so no aten op of
# theirs is seen on the CPU)
CALLBACK_PRIMS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "_unique",
    "_unique2", "unique_dim", "unique_consecutive", "equal", "bincount",
    "repeat_interleave", "index", "index_put", "index_put_",
    "tolist", "numpy", "repr",
})
TRANSFER_PRIMS = frozenset({"_to_copy", "copy_", "lift_fresh",
                            "lift_fresh_copy"})
_WRAPPED = ("tolist", "numpy", "__repr__")
_TORCH_DIR = os.path.dirname(torch.__file__)
_HERE = os.path.abspath(__file__)
_MARKS = os.path.abspath(marks.__file__)


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One recorded op: where it sits and what it consumes."""
    primitive: str
    path: str                    # enclosing marks, or the call site
    axes: Tuple[str, ...]        # named mesh axes (collectives only)
    dtypes: Tuple[str, ...]      # operand dtypes
    elements: int                # total operand elements
    nbytes: int                  # total operand bytes

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OpRecord":
        return cls(d["primitive"], d["path"], tuple(d["axes"]),
                   tuple(d["dtypes"]), int(d["elements"]), int(d["nbytes"]))


@dataclasses.dataclass(frozen=True)
class JaxprSummary:
    """Everything the recorder saw, as plain data (the reference's name and
    fields, plus the port's ``kernels`` and the op ``sequence`` that
    :func:`fingerprint` digests)."""
    counts: Dict[str, int]             # op name -> count
    collectives: Tuple[OpRecord, ...]
    callbacks: Tuple[OpRecord, ...]
    transfers: Tuple[OpRecord, ...]
    reduces: Tuple[OpRecord, ...]
    kernels: Tuple[str, ...] = ()      # kernel regions, in call order
    sequence: Tuple[str, ...] = ()     # "op(dtype[shape],...)" per op
    ops: Tuple["OpShapes", ...] = ()   # what the cost model prices

    def count(self, *prims: str) -> int:
        """Total count over the given op names."""
        return sum(self.counts.get(p, 0) for p in prims)

    @property
    def collective_count(self) -> int:
        return len(self.collectives)


Spec = Tuple[str, Tuple[int, ...]]     # (dtype, shape) of one tensor


@dataclasses.dataclass(frozen=True)
class OpShapes:
    """One op as the cost model sees it: ``kind`` "op" (an aten op),
    "kernel" (a kernel region, priced by ``work``) or "collective" (a
    ``MeshAxes`` call over ``axes``), with its operands' and results'
    (dtype, shape)."""
    primitive: str
    kind: str
    operands: Tuple[Spec, ...] = ()
    results: Tuple[Spec, ...] = ()
    axes: Tuple[str, ...] = ()
    work: Optional[marks.Work] = None


def _specs(tensors) -> Tuple[Spec, ...]:
    return tuple((_dtype(t.dtype), tuple(t.shape)) for t in tensors)


def _dtype(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _stats(tensors) -> Tuple[Tuple[str, ...], int, int]:
    dtypes, elements, nbytes = [], 0, 0
    for t in tensors:
        n = t.numel()
        dtypes.append(_dtype(t.dtype))
        elements += n
        nbytes += n * t.element_size()
    return tuple(dtypes), elements, nbytes


def _site() -> str:
    """The innermost frame outside torch and this recorder: file:line."""
    f = sys._getframe(1)
    while f is not None:
        name = os.path.abspath(f.f_code.co_filename)
        if not (name.startswith(_TORCH_DIR) or name in (_HERE, _MARKS)):
            parts = name.split(os.sep)
            return f"{'/'.join(parts[-2:])}:{f.f_lineno}"
        f = f.f_back
    return ""


def _tensors(args, kwargs) -> List[torch.Tensor]:
    return [t for t in _pytree_leaves((args, kwargs))
            if isinstance(t, torch.Tensor)]


class _Recorder(TorchDispatchMode):
    """The dispatch mode of one recording, and the regions' listener."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()
        self.lists = {k: [] for k in ("collectives", "callbacks",
                                      "transfers", "reduces")}
        self.kernels: List[str] = []
        self.sequence: List[str] = []
        self.stack: List[str] = []
        self.ops: List[OpShapes] = []
        self.opaque = 0      # open regions whose inner ops are not priced

    # -- what the marks call -------------------------------------------------
    def enter_region(self, kind, name, axes, tensor, dtype,
                     extra=None) -> None:
        if not self.opaque and kind == "kernel":
            self.ops.append(OpShapes(name, kind, work=extra()))
        elif not self.opaque and kind == "collective":
            shape = tuple(tensor.shape)
            if extra > 1:                     # all_gather's result
                shape = (extra * shape[0],) + shape[1:]
            self.ops.append(OpShapes(
                name, kind, _specs([tensor]),
                ((_dtype(tensor.dtype), shape),), tuple(axes)))
        if not self.stack:
            self.counts[name] += 1
            self.sequence.append(f"{kind}:{name}")
            if kind == "kernel":
                self.kernels.append(name)
            else:
                n = tensor.numel()
                dt = tensor.dtype if dtype is None else dtype
                rec = OpRecord(name, "", tuple(axes), (_dtype(dt),), n,
                               n * dt.itemsize)
                self.lists["collectives" if kind == "collective"
                           else "reduces"].append(rec)
        self.stack.append(f"{kind}:{name}")
        self.opaque += kind != "reduce"

    def exit_region(self) -> None:
        self.opaque -= not self.stack.pop().startswith("reduce:")

    def note(self, bucket: str, name: str, tensors) -> None:
        """A host read or transfer, at its call site."""
        dtypes, elements, nbytes = _stats(tensors)
        self.counts[name] += 1
        self.sequence.append(f"{bucket}:{name}")
        self.lists[bucket].append(OpRecord(name, _site(), (), dtypes,
                                           elements, nbytes))

    # -- the dispatch mode ---------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if FakeTensor in types or isinstance(_get_current_dispatch_mode(),
                                             FakeTensorMode):
            return func(*args, **kwargs)   # a DTensor propagating shardings
        if types and _unwraps(types):
            return NotImplemented          # its local ops come back here
        out = func(*args, **kwargs)
        if self.opaque:
            return out
        name = func.overloadpacket.__name__
        ts = _tensors(args, kwargs)
        results = _specs(t for t in _pytree_leaves(out)
                         if isinstance(t, torch.Tensor))
        coll = name in FUNCTIONAL_COLLECTIVES \
            and func.namespace == "_c10d_functional"
        axes = _group_of(func, args, kwargs) if coll else ()
        self.ops.append(OpShapes(name, "collective" if coll else "op",
                                 _specs(ts), results, axes))
        if self.stack:
            return out
        self.counts[name] += 1
        self.sequence.append(f"{func}(" + ",".join(
            f"{_dtype(t.dtype)}{list(t.shape)}" for t in ts) + ")")
        if coll:
            dtypes, elements, nbytes = _stats(ts)
            self.lists["collectives"].append(OpRecord(
                name, "", axes, dtypes, elements, nbytes))
        elif name in REDUCE_PRIMS:
            dtypes, elements, nbytes = _stats(ts)
            self.lists["reduces"].append(OpRecord(
                name, "/".join(self.stack), (), dtypes, elements, nbytes))
        elif name in CALLBACK_PRIMS and _host_read(name, args, kwargs):
            self.note("callbacks", name, ts)
        elif name in TRANSFER_PRIMS and _moves(name, args, kwargs):
            self.note("transfers", name, ts)
        return out

    def summary(self) -> JaxprSummary:
        return JaxprSummary(
            dict(self.counts), tuple(self.lists["collectives"]),
            tuple(self.lists["callbacks"]), tuple(self.lists["transfers"]),
            tuple(self.lists["reduces"]), tuple(self.kernels),
            tuple(self.sequence), tuple(self.ops))


def _unwraps(types) -> bool:
    """Does one of the tensor subclasses ``types`` unwrap to plain tensors
    when the mode declines the op: a DTensor, or a functional collective's
    result that has not been waited on?"""
    mods = [sys.modules.get("torch.distributed.tensor"),
            sys.modules.get("torch.distributed._functional_collectives")]
    wrappers = tuple(t for m, attr in zip(mods, ("DTensor",
                                                 "AsyncCollectiveTensor"))
                     if m is not None for t in (getattr(m, attr),))
    return any(issubclass(t, wrappers) for t in types)


def _group_of(func, args, kwargs) -> Tuple[str, ...]:
    """The mesh axes of a functional collective's process group."""
    names = [a.name for a in func._schema.arguments]
    bound = dict(zip(names, args), **kwargs)
    return marks.group_axes(bound["group_name"])


def _host_read(name: str, args, kwargs) -> bool:
    """Is this op a host read?  ``repeat_interleave`` only with tensor
    repeats and no output size; indexing only with a boolean index."""
    if name == "repeat_interleave":
        return (len(args) < 2 or isinstance(args[1], torch.Tensor)) \
            and kwargs.get("output_size") is None
    if name in ("index", "index_put", "index_put_"):
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        return any(isinstance(i, torch.Tensor)
                   and i.dtype in (torch.bool, torch.uint8) for i in idx)
    return True


def _moves(name: str, args, kwargs) -> bool:
    """Does this copy change device (or build a tensor from host data)?"""
    if name.startswith("lift_fresh"):
        return True
    if name == "_to_copy":
        dev = kwargs.get("device")
        return dev is not None and torch.device(dev) != args[0].device
    return args[0].device != args[1].device   # copy_(dst, src)


def _wrap(rec: _Recorder, attr: str, orig: Callable):
    label = "repr" if attr == "__repr__" else attr

    def read(self, *args, **kwargs):
        if rec.stack:
            return orig(self, *args, **kwargs)
        rec.note("callbacks", label, [self])
        rec.stack.append(f"callback:{label}")
        rec.opaque += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            rec.opaque -= 1
            rec.stack.pop()
    return read


def record(fn: Callable, *args, **kwargs) -> JaxprSummary:
    """Run ``fn(*args, **kwargs)`` once under the recorder and return what
    it saw.  The arguments are used as given (see :func:`trace`)."""
    if marks._recorder is not None:
        raise RuntimeError("a recording is already running: the recorder "
                           "does not nest")
    rec = _Recorder()
    saved = {a: torch.Tensor.__dict__.get(a) for a in _WRAPPED}
    marks._recorder = rec
    try:
        for a in _WRAPPED:
            setattr(torch.Tensor, a, _wrap(rec, a, getattr(torch.Tensor, a)))
        with rec:
            fn(*args, **kwargs)
    finally:
        marks._recorder = None
        for a, orig in saved.items():
            if orig is None:
                delattr(torch.Tensor, a)
            else:
                setattr(torch.Tensor, a, orig)
    return rec.summary()


def trace(fn: Callable, *args, **kwargs) -> JaxprSummary:
    """The summary of one call of ``fn`` on deep copies of its arguments
    (on their devices), its output dropped: the one-liner the tests use,
    and what the executors' ``sync_program``/``round_program`` record."""
    args, kwargs = copy.deepcopy((args, kwargs))
    return record(fn, *args, **kwargs)


def fingerprint(summary: JaxprSummary) -> str:
    """Stable digest of a recorded program: the op sequence with each
    operand's dtype and shape — never values or addresses — so two
    fingerprints are equal iff the calls ran the same ops on the same
    shapes (the 'program-identical' claim the tests assert)."""
    text = "\n".join(summary.sequence)
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]
