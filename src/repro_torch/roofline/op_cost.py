"""The op-stream cost model: the eager counterpart of
``repro.roofline.hlo_cost``.

The reference parses compiled HLO.  An eager program has none, so this
prices the op stream that the analysis layer's recorder
(:mod:`repro_torch.analysis.walker`) keeps of one call: every aten op with
its operands' and results' dtypes and shapes, every kernel region with its
work, every collective with its result.  The reference's rules
(``hlo_cost.py:287-354``) where an eager op has a counterpart:

  * products      — 2 * result elements * contraction (``_dot_flops``);
                    convolution 2 * result elements * (weight elements /
                    out channels) (``_conv_flops``); FLOPs of 16-bit float
                    operands in the "bf16" class, others in "f32"
  * elementwise   — result elements ("other")
  * reductions    — operand bytes / 4 ("other")
  * views         — nothing moves: 0 bytes (allocations too)
  * copies        — 2 * result bytes (``copy``)
  * gathers       — 2 * result bytes (``slice``/``gather``)
  * every other op — operands read plus results written; an eager op is a
                    top-level instruction, nothing fuses
  * kernel regions — their kernel's :class:`~repro_torch.marks.Work`, never
                    the ops inside (on the card nothing is seen there, on
                    the CPU the plain version runs), so a call prices the
                    same on either device
  * collectives   — result bytes (an all-gather its gathered size), cross-
                    node when the op's axes hold the hierarchy's top level;
                    ``MeshAxes`` calls and torch's functional collectives
                    alike (their waits move nothing more)

Eager records every iteration of a loop, so the reference's trip-count fix
(``_trip``) holds by construction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.walker import OpShapes, Spec
from repro_torch.marks import FLOP_CLASSES

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_KIND = {"psum": "all-reduce", "pmax": "all-reduce",
                    "all_gather": "all-gather",
                    # torch's functional collectives (DTensor's)
                    "all_reduce": "all-reduce",
                    "all_gather_into_tensor": "all-gather",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_to_all_single": "all-to-all"}

# the contraction operand of each product (its last dim is contracted)
_PRODUCTS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1, "baddbmm": 1,
             "addmv": 1}
_CONVOLUTIONS = {"convolution", "convolution_backward"}
# the reference's _ELEMENTWISE (hlo_cost.py:34) by their aten names, with
# the activations and their backward ops, which XLA breaks into those
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "pow", "tanh", "exp", "log",
    "rsqrt", "sqrt", "maximum", "minimum", "neg", "abs", "floor", "ceil",
    "sign", "cos", "sin", "sigmoid", "atan2", "remainder", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and", "logical_or",
    "logical_xor", "logical_not", "where", "clamp", "clamp_min", "clamp_max",
    "eq", "ne", "lt", "le", "gt", "ge", "expm1", "log1p", "erf",
    "reciprocal", "masked_fill", "relu", "silu", "gelu", "softplus",
    "tanh_backward", "sigmoid_backward", "silu_backward", "gelu_backward",
    "threshold_backward", "softplus_backward",
}
_REDUCE_LIKE = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "linalg_vector_norm", "norm", "argmax", "argmin", "any", "all",
    "logsumexp", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "cumsum",
}
_VIEWS = {
    "view", "_unsafe_view", "expand", "permute", "t", "transpose", "slice",
    "select", "as_strided", "alias", "unsqueeze", "squeeze", "detach",
    "split", "split_with_sizes", "unbind", "narrow", "unfold", "diagonal",
    "_reshape_alias", "lift_fresh", "chunk",
    # a functional collective's wait and autograd wrapper: its bytes are
    # the collective's
    "wait_tensor", "_wrap_tensor_autograd",
    # allocations: nothing is read or written yet
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided",
}
_COPIES = {"copy", "clone"}
_GATHERS = {"index", "gather", "index_select", "embedding"}


@dataclasses.dataclass
class Cost:
    """One call's price: FLOPs by class, bytes, collective bytes (intra-
    and cross-node, and by kind) and the kernel regions by name."""
    flops: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(FLOP_CLASSES, 0.0))
    bytes: float = 0.0
    coll_intra: float = 0.0
    coll_cross: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    regions: Dict[str, int] = dataclasses.field(default_factory=dict)


_ITEMSIZE: Dict[str, int] = {}


def _nbytes(specs: Iterable[Spec]) -> int:
    total = 0
    for dt, shape in specs:
        if dt not in _ITEMSIZE:
            _ITEMSIZE[dt] = getattr(torch, dt).itemsize
        total += math.prod(shape) * _ITEMSIZE[dt]
    return total


def _elems(specs: Iterable[Spec]) -> int:
    return sum(math.prod(shape) for _, shape in specs)


def _product_class(dtype: str) -> str:
    return "bf16" if dtype in ("bfloat16", "float16") else "f32"


def op_cost(op: OpShapes) -> Tuple[Optional[str], float, float]:
    """(FLOP class, FLOPs, bytes) of one aten op."""
    name = op.primitive.rstrip("_") if not op.primitive.startswith("_") \
        else op.primitive
    ins, outs = op.operands, op.results
    moved = float(_nbytes(ins) + _nbytes(outs))
    if name in _VIEWS:
        return None, 0.0, 0.0
    if name in _PRODUCTS:
        dt, shape = ins[_PRODUCTS[name]]
        return (_product_class(dt), 2.0 * _elems(outs) * shape[-1], moved)
    if name in _CONVOLUTIONS:
        # input, weight (out, in / groups, *kernel): per output element
        # the weight's elements over its out channels; the backward
        # computes the input's and the weight's gradients, each that much
        (dt, _), (_, w) = ins[0], ins[1]
        per = math.prod(w) // max(w[0], 1)
        if name == "convolution":
            return _product_class(dt), 2.0 * _elems(outs[:1]) * per, moved
        return _product_class(dt), 4.0 * _elems(ins[:1]) * per, moved
    if name in _ELEMENTWISE:
        return "other", float(_elems(outs)), moved
    if name in _REDUCE_LIKE:
        # the reference's rule as it stands (hlo_cost.py:351): operand
        # bytes / 4, which is elements for float32 only
        return "other", _nbytes(ins) / 4.0, moved
    if name in _COPIES or name in _GATHERS:
        return None, 0.0, 2.0 * _nbytes(outs)
    return None, 0.0, moved


def price(ops: Sequence[OpShapes], top_axis: str = "pod") -> Cost:
    """The :class:`Cost` of a recorded call's ``ops``; a collective whose
    axes hold ``top_axis`` (the hierarchy's top level) is cross-node, as
    the reference's replica groups spanning two pods
    (``hlo_cost.py:265-285``)."""
    c = Cost()
    for op in ops:
        if op.kind == "kernel":
            for cls, f in op.work.flops.items():
                c.flops[cls] += f
            c.bytes += op.work.bytes
            c.regions[op.primitive] = c.regions.get(op.primitive, 0) + 1
        elif op.kind == "collective":
            nbytes = _nbytes(op.results)
            c.coll_by_kind[_COLLECTIVE_KIND[op.primitive]] += nbytes
            if top_axis in op.axes:
                c.coll_cross += nbytes
            else:
                c.coll_intra += nbytes
        else:
            cls, f, b = op_cost(op)
            if cls is not None:
                c.flops[cls] += f
            c.bytes += b
    return c
