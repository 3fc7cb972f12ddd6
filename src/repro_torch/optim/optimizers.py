"""Optimizers (PyTorch counterpart of ``repro.optim.optimizers``).

``update`` returns the delta to ADD to params.  The LR may be a float or a
schedule ``step -> float``; ``step`` is threaded through opt_state as an
int32 tensor.  This slice ports ``sgd``, the paper's optimizer; momentum
and adam come with ROADMAP item A3's remainder.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Schedule = Union[float, Callable[[torch.Tensor], Any]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return torch.as_tensor(lr(step), dtype=torch.float32,
                               device=step.device)
    return torch.full((), lr, dtype=torch.float32, device=step.device)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]  # (grads, state, params) -> (updates, state)


def sgd(lr: Schedule) -> Optimizer:
    """Plain SGD — the paper's optimizer (Algorithm 1 line 5)."""
    def init(params):
        device = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        del params
        g = _lr_at(lr, state["step"])
        upd = tree_map(lambda x: (-g * x.to(torch.float32)).to(x.dtype),
                       grads)
        return upd, {"step": state["step"] + 1}

    return Optimizer(init, update)
