"""The resolved comms plan: codec plus wire-path switch, bound per engine
(PyTorch counterpart of ``repro.comms.sync``).

``EngineConfig(comms=...)`` resolves through :func:`make_comms` into a
:class:`Comms` (or None = comms off).  A ``Comms`` owns HOW a sync payload
crosses the wire — one fused flat buffer per dtype or raw leaves, through
which codec — while the executor passes its own ``reduce_fn``.  Not ported
yet: error-feedback residuals, which only the top-k codec uses (ROADMAP
B6).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

from repro_torch.comms.codecs import Compressor, CompressorLike, make_compressor
from repro_torch.comms.flat import FlatBucket
from repro_torch.comms.wire import WireArray
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


class Comms:
    """compressor: a codec instance, registry name, or None (identity).
    bucket: fuse the tree into one buffer per dtype before encoding; False
    keeps leaf-wise payloads.  With a block-statistics codec (int8, sign)
    the layout changes which elements share a block, so the two give
    different trajectories.  wire_reduce: let executors hand eligible
    syncs to the codec's compressed-collective form instead of the
    per-worker encode/decode roundtrip; False forces the roundtrip
    everywhere.  Extra kwargs construct the codec by name (e.g.
    ``Comms("sign", block=256)``)."""

    def __init__(self, compressor: CompressorLike = None, *,
                 bucket: bool = True, wire_reduce: bool = True,
                 **codec_kwargs):
        self.codec = make_compressor(compressor, **codec_kwargs)
        self.bucket = bool(bucket)
        self.wire_reduce = bool(wire_reduce)
        self._plans: Dict[Any, FlatBucket] = {}

    def __repr__(self):
        return f"Comms({self.codec!r}, bucket={self.bucket})"

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

        ``reduce_mode=None``: bucketize (unless ``bucket=False``),
        codec-roundtrip each worker's payload, reduce the decoded payloads
        with ``reduce_fn``, restore the tree.  ``reduce_mode=<WireOps>``:
        hand each payload to the codec's compressed collective
        (``reduce_fn`` unused).  Layout-free codecs under the sim backend
        skip the bucket: it would only move data."""
        if not self.bucket or (
                reduce_mode is not None and self.codec.layout_free
                and getattr(reduce_mode, "backend", None) == "sim"):
            payload, fb = tree, None
        else:
            fb = self._plan(tree)
            payload = fb.flatten(tree)
        if reduce_mode is not None:
            reduced = tree_map(lambda x: self.codec.reduce(x, reduce_mode),
                               payload)
        else:
            reduced = reduce_fn(tree_map(self.codec.roundtrip, payload))
        return reduced if fb is None else fb.unflatten(reduced)

    def payload_spec(self, params) -> Tuple[Tuple[WireArray, ...], int]:
        """Static (wire arrays, element count) for ONE worker's payload."""
        for leaf in tree_leaves(params):
            if leaf.ndim < 1:
                raise ValueError(
                    "payload_spec expects every leaf to carry a leading "
                    "worker axis; a rank-0 leaf's per-worker element count "
                    "would be miscounted.  Stack worker replicas on axis 0.")
        if self.bucket:
            fb = self._plan(params)
            parts = [(key, fb.lengths[key], fb.dtypes[key])
                     for key in sorted(fb.lengths)]
        else:
            parts = [(f"leaf{i}", math.prod(leaf.shape[1:]), leaf.dtype)
                     for i, leaf in enumerate(tree_leaves(params))]
        arrays = [WireArray(f"{key}.{a.name}", a.shape, a.dtype)
                  for key, n, dtype in parts
                  for a in self.codec.wire_spec(n, dtype)]
        return tuple(arrays), sum(n for _, n, _ in parts)


CommsLike = Union[str, Compressor, Comms, None]


def make_comms(spec: CommsLike = None, **kwargs) -> Optional[Comms]:
    """Resolve ``EngineConfig(comms=...)``: None = off, a codec name or
    Compressor = bucketized comms with that codec, or a ready Comms;
    ``kwargs`` go to :class:`Comms` (``bucket``, ``wire_reduce``, the
    codec's own)."""
    if spec is None and not kwargs:
        return None
    if isinstance(spec, Comms):
        if kwargs:
            raise ValueError(f"kwargs {sorted(kwargs)} only apply when "
                             f"constructing by name; got {spec!r}")
        return spec
    return Comms(spec, **kwargs)
