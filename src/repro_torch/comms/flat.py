"""FlatBucket: DDP-style bucketization of a worker-stacked tree (PyTorch
counterpart of ``repro.comms.flat``).

A :class:`FlatBucket` flattens the tree into ONE contiguous
``(workers, length)`` buffer per dtype, so a sync aggregates O(dtypes)
fused buffers instead of O(leaves) tensors.

Leaf order: leaves are concatenated in ``jax.tree.flatten``'s order —
dict keys sorted (:mod:`repro_torch.tree`).  The int8 codec's block scales
depend on which elements share a block, so any other order would give
other wire bytes and a different trajectory than the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.comms.wire import dtype_name
from repro_torch.tree import TreeDef, tree_flatten


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside its bucket."""
    bucket: str                 # dtype-name key
    offset: int                 # element offset within the per-worker row
    size: int                   # elements per worker
    shape: Tuple[int, ...]      # full leaf shape (worker axis included)
    dtype: Any


@dataclasses.dataclass(frozen=True)
class FlatBucket:
    """Flatten/unflatten plan for one tree signature; ``flatten`` and
    ``unflatten`` are exact inverses (bucketization only moves data)."""
    treedef: TreeDef
    slots: Tuple[LeafSlot, ...]
    lengths: Dict[str, int]     # per-worker elements per bucket
    dtypes: Dict[str, Any]      # bucket key -> torch dtype

    @classmethod
    def plan(cls, tree) -> "FlatBucket":
        leaves, treedef = tree_flatten(tree)
        slots, lengths, dtypes = [], {}, {}
        for leaf in leaves:
            shape = tuple(leaf.shape)
            assert len(shape) >= 1, \
                "bucketized leaves need a leading worker axis"
            key = dtype_name(leaf.dtype)
            size = 1
            for d in shape[1:]:
                size *= int(d)
            off = lengths.get(key, 0)
            slots.append(LeafSlot(key, off, size, shape, leaf.dtype))
            lengths[key] = off + size
            dtypes[key] = leaf.dtype
        return cls(treedef, tuple(slots), dict(lengths), dict(dtypes))

    def flatten(self, tree) -> Dict[str, torch.Tensor]:
        """tree -> {dtype-name: (workers, length)} fused buffers."""
        leaves = self.treedef.flatten_up_to(tree)
        rows: Dict[str, list] = {}
        for slot, leaf in zip(self.slots, leaves):
            rows.setdefault(slot.bucket, []).append(
                leaf.reshape(leaf.shape[0], -1))
        return {k: (v[0] if len(v) == 1 else torch.cat(v, dim=1))
                for k, v in rows.items()}

    def unflatten(self, bufs: Dict[str, torch.Tensor]):
        """Inverse of :meth:`flatten` (tolerates a changed worker-axis
        size)."""
        leaves = []
        for slot in self.slots:
            buf = bufs[slot.bucket]
            piece = buf[:, slot.offset:slot.offset + slot.size]
            leaves.append(piece.reshape((buf.shape[0],) + slot.shape[1:])
                          .to(slot.dtype))
        return self.treedef.unflatten(leaves)
