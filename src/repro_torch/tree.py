"""Minimal pytree helpers over nested dicts of tensors.

Leaf order is ``jax.tree.flatten``'s: dict keys in SORTED order.  The
order matters beyond style: the comms buckets concatenate leaves in it,
and the int8 block scales depend on which elements share a block (see
:mod:`repro_torch.comms.flat`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """Hashable structure of a tree: None for a leaf, else a tuple of
    (key, child structure) pairs in sorted key order."""
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
    leaves.append(t)
    return None


def _build(spec, it):
    if spec is None:
        return next(it)
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
