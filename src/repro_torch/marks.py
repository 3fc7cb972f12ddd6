"""Marks that the analysis layer's recorder reads
(:mod:`repro_torch.analysis.walker`).

An eager program is only seen op by op, and three kinds of op do not mean
there what they mean to the reference's jaxpr walker.  The code that runs
them marks them, so the recorder can count each as one thing:

* :func:`kernel` — a hand-written kernel's wrapper call.  The kernels are
  loaded with ``ctypes``, so the card's ops inside a call are invisible,
  and on the CPU the wrapper runs the plain version, whose ops would be
  seen.  The recorder lists the region by name and counts nothing inside
  it, as the reference drops what sits under a ``pallas_call``; the cost
  model (:mod:`repro_torch.roofline`) prices it by its :class:`Work`.
* :func:`collective` — one ``MeshAxes`` collective: one record with its
  axis names and its operand's dtype, elements and bytes.  Under ``gloo``
  a collective stages its operand through the host; that staging belongs
  to the collective and is not recorded as a transfer.
* :func:`reduce` — an aggregation that the port sums member after member
  to take XLA's order (``comms.codecs._member_sum``, a bf16
  ``core.aggregators._sum_in``): one reduce of the operand, as the
  reference's one ``reduce_sum``; the adds inside are not recorded.

With no recorder active each mark is a shared null context: a global read
and nothing else.

torch's own functional collectives (a DTensor's redistributions) are
seen by the recorder as aten ops with a process group's name;
:func:`name_groups` tells it which mesh axes each group spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

# the recorder of the call being recorded, or None (set by the walker)
_recorder = None
_NULL = contextlib.nullcontext()
# process group name -> the mesh axes it spans (see name_groups)
_group_axes: Dict[str, Tuple[str, ...]] = {}


# the cost model's FLOP classes, each priced at its own rate: products of
# 16-bit floats (the tensor cores), float32 products, and everything else
FLOP_CLASSES = ("bf16", "f32", "other")


@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call must do, from its shapes alone: FLOPs by class
    (:data:`FLOP_CLASSES`) and the bytes it must read and write, each
    input read once and each output written once.  A call that runs in
    stages, one after the other (a pre-pass, then the main launch), is
    :meth:`in_turn` of its stages: its FLOPs and bytes are their sums,
    and its bound is the sum of theirs."""
    flops: Dict[str, float]
    bytes_read: int
    bytes_written: int
    stages: Tuple["Work", ...] = ()

    @property
    def bytes(self) -> int:
        return self.bytes_read + self.bytes_written

    @classmethod
    def in_turn(cls, *stages: "Work") -> "Work":
        flops: Dict[str, float] = {}
        for w in stages:
            for c, f in w.flops.items():
                flops[c] = flops.get(c, 0) + f
        return cls(flops, sum(w.bytes_read for w in stages),
                   sum(w.bytes_written for w in stages), tuple(stages))


class _Region:
    """One marked region; ``extra`` is a kernel's work (a function of no
    arguments) or an ``all_gather``'s member count."""
    __slots__ = ("rec", "kind", "name", "axes", "tensor", "dtype", "extra")

    def __init__(self, rec, kind: str, name: str, axes=(), tensor=None,
                 dtype=None, extra=None):
        self.rec, self.kind, self.name = rec, kind, name
        self.axes, self.tensor, self.dtype = axes, tensor, dtype
        self.extra = extra

    def __enter__(self):
        self.rec.enter_region(self.kind, self.name, self.axes, self.tensor,
                              self.dtype, self.extra)
        return self

    def __exit__(self, *exc):
        self.rec.exit_region()
        return False


def kernel(name: str, work: Callable[[], Work]):
    """The region of one call of kernel ``name``'s wrapper; ``work()``
    gives the call's :class:`Work` and is called only while recording."""
    rec = _recorder
    return _NULL if rec is None else _Region(rec, "kernel", name,
                                             extra=work)


def collective(op: str, axes: Sequence[str], t: torch.Tensor,
               members: int = 1):
    """The region of one collective ``op`` over the mesh axes ``axes``, on
    ``t``; an ``all_gather`` returns ``members`` times ``t``."""
    rec = _recorder
    return _NULL if rec is None else _Region(rec, "collective", op,
                                             tuple(axes), t, extra=members)


def reduce(name: str, t: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """The region of one member-by-member reduce of ``t``, accumulated in
    ``dtype`` (``t``'s own by default): the record's operand dtype."""
    rec = _recorder
    return _NULL if rec is None else _Region(rec, "reduce", name, (), t,
                                             dtype)


def name_groups(axes: Dict[str, Tuple[str, ...]]) -> None:
    """Record the mesh axes each process group spans, by group name."""
    _group_axes.update({k: tuple(v) for k, v in axes.items()})


def forget_groups() -> None:
    """Forget every named group (a group's name is reused by the next
    world)."""
    _group_axes.clear()


def group_axes(group_name: str) -> Tuple[str, ...]:
    """The mesh axes of the process group ``group_name``; raises for a
    group that :func:`name_groups` did not name."""
    if group_name not in _group_axes:
        raise KeyError(f"process group {group_name!r} spans no named mesh "
                       "axes: build the mesh with repro_torch.launch.mesh."
                       "make_production_mesh or name_mesh_groups")
    return _group_axes[group_name]
