"""Minimal pytree helpers over nested dicts, tuples and lists of tensors.

Leaf order is ``jax.tree.flatten``'s: dict keys in SORTED order, tuple and
list children in index order, and ``None`` a node with no leaves.  The
order matters beyond style: the comms buckets concatenate leaves in it,
the int8 block scales depend on which elements share a block (see
:mod:`repro_torch.comms.flat`), and a checkpoint stores leaves in it (see
:mod:`repro_torch.checkpoint`).  An LM's params hold their blocks in
tuples of dicts (``models/transformer.py``), so tuples must be nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


@dataclasses.dataclass(frozen=True)
class _Seq:
    """Structure of a tuple or list node: its type and its children's
    structures in index order."""
    kind: type
    children: Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class _NoneNode:
    """Structure of a ``None`` node (no leaves, as in ``jax.tree``)."""


_NONE = _NoneNode()


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """Hashable structure of a tree: None for a leaf, a tuple of (key,
    child structure) pairs in sorted key order for a dict, a ``_Seq`` for
    a tuple or list and ``_NONE`` for ``None``."""
    spec: Any

    def unflatten(self, leaves):
        it = iter(leaves)
        out = _build(self.spec, it)
        if next(it, None) is not None:
            raise ValueError(f"too many leaves for {self}")
        return out

    def flatten_up_to(self, tree) -> List[Any]:
        leaves, other = tree_flatten(tree)
        if other != self:
            raise ValueError(f"tree structure {other} does not match {self}")
        return leaves


def _spec(t, leaves: List[Any]):
    if isinstance(t, dict):
        return tuple((k, _spec(t[k], leaves)) for k in sorted(t))
    if isinstance(t, (tuple, list)):
        return _Seq(type(t), tuple(_spec(c, leaves) for c in t))
    if t is None:
        return _NONE
    leaves.append(t)
    return None


def _build(spec, it):
    if spec is None:
        return next(it)
    if spec is _NONE:
        return None
    if isinstance(spec, _Seq):
        return spec.kind(_build(s, it) for s in spec.children)
    return {k: _build(s, it) for k, s in spec}


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []
    spec = _spec(tree, leaves)
    return leaves, TreeDef(spec)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    leaves, tdef = tree_flatten(tree)
    others = [tdef.flatten_up_to(r) for r in rest]
    return tdef.unflatten([fn(*xs) for xs in zip(leaves, *others)])
