"""The resolved comms plan: codec plus wire-path switch, bound per engine
(PyTorch counterpart of ``repro.comms.sync``).

``EngineConfig(comms=...)`` resolves through :func:`make_comms` into a
:class:`Comms` (or None = comms off).  A ``Comms`` owns HOW a sync payload
crosses the wire — one fused flat buffer per dtype, through which codec —
while the executor passes its own ``reduce_fn``.  Not ported yet: leaf-wise
payloads (``bucket=False``) and error-feedback residuals, which only the
top-k codec uses (ROADMAP B6).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

from repro_torch.comms.codecs import Compressor, CompressorLike, make_compressor
from repro_torch.comms.flat import FlatBucket
from repro_torch.comms.wire import WireArray
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


class Comms:
    """compressor: a codec instance, registry name, or None (identity).
    wire_reduce: let executors hand eligible syncs to the codec's
    compressed-collective form instead of the per-worker encode/decode
    roundtrip; False forces the roundtrip everywhere."""

    def __init__(self, compressor: CompressorLike = None, *,
                 wire_reduce: bool = True):
        self.codec = make_compressor(compressor)
        self.wire_reduce = bool(wire_reduce)
        self._plans: Dict[Any, FlatBucket] = {}

    def __repr__(self):
        return f"Comms({self.codec!r})"

    def _plan(self, tree) -> FlatBucket:
        """Bucket plan per tree signature (structure, shapes, dtypes)."""
        leaves, treedef = tree_flatten(tree)
        key = (treedef, tuple((tuple(l.shape), l.dtype) for l in leaves))
        fb = self._plans.get(key)
        if fb is None:
            fb = self._plans[key] = FlatBucket.plan(tree)
        return fb

    def sync(self, tree, reduce_fn: Callable[[Any], Any],
             reduce_mode: Optional[Any] = None):
        """Aggregate ``tree`` through the wire.

        ``reduce_mode=None``: bucketize, codec-roundtrip each worker's
        payload, reduce the decoded payloads with ``reduce_fn``, restore the
        tree.  ``reduce_mode=<WireOps>``: hand each bucket to the codec's
        compressed collective (``reduce_fn`` unused).  Layout-free codecs
        under the sim backend skip the bucket: it would only move data."""
        if (reduce_mode is not None and self.codec.layout_free
                and getattr(reduce_mode, "backend", None) == "sim"):
            return tree_map(lambda x: self.codec.reduce(x, reduce_mode), tree)
        fb = self._plan(tree)
        bufs = fb.flatten(tree)
        if reduce_mode is not None:
            reduced = {k: self.codec.reduce(v, reduce_mode)
                       for k, v in bufs.items()}
        else:
            reduced = reduce_fn({k: self.codec.roundtrip(v)
                                 for k, v in bufs.items()})
        return fb.unflatten(reduced)

    def payload_spec(self, params) -> Tuple[Tuple[WireArray, ...], int]:
        """Static (wire arrays, element count) for ONE worker's payload."""
        for leaf in tree_leaves(params):
            if leaf.ndim < 1:
                raise ValueError(
                    "payload_spec expects every leaf to carry a leading "
                    "worker axis; a rank-0 leaf's per-worker element count "
                    "would be miscounted.  Stack worker replicas on axis 0.")
        fb = self._plan(params)
        arrays = []
        for key in sorted(fb.lengths):
            for a in self.codec.wire_spec(fb.lengths[key], fb.dtypes[key]):
                arrays.append(WireArray(f"{key}.{a.name}", a.shape, a.dtype))
        return tuple(arrays), sum(fb.lengths.values())


CommsLike = Union[str, Compressor, Comms, None]


def make_comms(spec: CommsLike = None) -> Optional[Comms]:
    """Resolve ``EngineConfig(comms=...)``: None = off, a codec name or
    Compressor = bucketized comms with that codec, or a ready Comms."""
    if spec is None:
        return None
    if isinstance(spec, Comms):
        return spec
    return Comms(spec)
