"""Marks that the analysis layer's recorder reads
(:mod:`repro_torch.analysis.walker`).

An eager program is only seen op by op, and three kinds of op do not mean
there what they mean to the reference's jaxpr walker.  The code that runs
them marks them, so the recorder can count each as one thing:

* :func:`kernel` — a hand-written kernel's wrapper call.  The kernels are
  loaded with ``ctypes``, so the card's ops inside a call are invisible,
  and on the CPU the wrapper runs the plain version, whose ops would be
  seen.  The recorder lists the region by name and counts nothing inside
  it, as the reference drops what sits under a ``pallas_call``.
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
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

# the recorder of the call being recorded, or None (set by the walker)
_recorder = None
_NULL = contextlib.nullcontext()


class _Region:
    __slots__ = ("rec", "kind", "name", "axes", "tensor", "dtype")

    def __init__(self, rec, kind: str, name: str, axes=(), tensor=None,
                 dtype=None):
        self.rec, self.kind, self.name = rec, kind, name
        self.axes, self.tensor, self.dtype = axes, tensor, dtype

    def __enter__(self):
        self.rec.enter_region(self.kind, self.name, self.axes, self.tensor,
                              self.dtype)
        return self

    def __exit__(self, *exc):
        self.rec.exit_region()
        return False


def kernel(name: str):
    """The region of one call of kernel ``name``'s wrapper."""
    rec = _recorder
    return _NULL if rec is None else _Region(rec, "kernel", name)


def collective(op: str, axes: Sequence[str], t: torch.Tensor):
    """The region of one collective ``op`` over the mesh axes ``axes``."""
    rec = _recorder
    return _NULL if rec is None else _Region(rec, "collective", op,
                                             tuple(axes), t)


def reduce(name: str, t: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """The region of one member-by-member reduce of ``t``, accumulated in
    ``dtype`` (``t``'s own by default): the record's operand dtype."""
    rec = _recorder
    return _NULL if rec is None else _Region(rec, "reduce", name, (), t,
                                             dtype)
