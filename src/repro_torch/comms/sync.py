"""The resolved comms plan: codec plus wire-path switch, bound per engine
(PyTorch counterpart of ``repro.comms.sync``).

``EngineConfig(comms=...)`` resolves through :func:`make_comms` into a
:class:`Comms` (or None = comms off).  A ``Comms`` owns HOW a sync payload
crosses the wire — one fused flat buffer per dtype or raw leaves, through
which codec — while the executor passes its own ``reduce_fn``.  A stateful
codec (top-k) carries per-worker error-feedback residuals, shaped like the
payload, in ``HSGDState.comms``: :meth:`Comms.init_state` makes them and
:meth:`Comms.sync` threads them.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

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

    def _payloads(self, tree):
        """tree -> (the payload tree the codec sees, FlatBucket or None)."""
        if not self.bucket:
            return tree, None
        fb = self._plan(tree)
        return fb.flatten(tree), fb

    def init_state(self, params):
        """Per-worker error-feedback residuals (f32 zeros shaped like the
        payload, worker axis first), or None for a stateless codec."""
        if not self.codec.stateful:
            return None
        payload, _ = self._payloads(params)
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), payload)

    def sync(self, tree, reduce_fn: Callable[[Any], Any],
             reduce_mode: Optional[Any] = None,
             residual: Optional[Any] = None):
        """Aggregate ``tree`` through the wire.

        ``reduce_mode=None``: bucketize (unless ``bucket=False``),
        codec-roundtrip each worker's payload, reduce the decoded payloads
        with ``reduce_fn``, restore the tree.  ``reduce_mode=<WireOps>``:
        hand each payload to the codec's compressed collective
        (``reduce_fn`` unused).  Layout-free stateless codecs under the sim
        backend skip the bucket: it would only move data.

        With a ``residual`` (a stateful codec's ``init_state`` tree), the
        residual rule: the codec adds it before encoding and the pair
        (aggregated tree, new residual) comes back; without one, the tree
        alone."""
        if reduce_mode is not None and self.codec.layout_free \
                and not self.codec.stateful \
                and getattr(reduce_mode, "backend", None) == "sim":
            payload, fb = tree, None
        else:
            payload, fb = self._payloads(tree)
        leaves, tdef = tree_flatten(payload)
        new_res = None
        if residual is not None and self.codec.stateful:
            res = tdef.flatten_up_to(residual)
            if reduce_mode is not None:
                pairs = [self.codec.reduce(x, reduce_mode, r)
                         for x, r in zip(leaves, res)]
            else:
                pairs = [self.codec.roundtrip(x, r)
                         for x, r in zip(leaves, res)]
            sent = tdef.unflatten([p for p, _ in pairs])
            new_res = tdef.unflatten([r for _, r in pairs])
        elif reduce_mode is not None:
            sent = tdef.unflatten([self.codec.reduce(x, reduce_mode)
                                   for x in leaves])
        else:
            sent = tdef.unflatten([self.codec.roundtrip(x) for x in leaves])
        reduced = sent if reduce_mode is not None else reduce_fn(sent)
        out = reduced if fb is None else fb.unflatten(reduced)
        return out if residual is None else (out, new_res)

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
