"""Optimizers (PyTorch counterpart of ``repro.optim.optimizers``).

``update`` returns the delta to ADD to params.  The LR may be a float or a
schedule ``step -> float`` (:mod:`repro_torch.optim.schedule`); ``step`` is
threaded through opt_state as an int32 tensor.  The moments of
``momentum`` and ``adam`` live under the reference's state keys ``m`` and
``v``, which is where a sync finds them (``core.hsgd._moments_only``).

Division rule: adam's bias corrections ``c1``, ``c2`` depend on the step,
so the reference divides by them for real; here they are tensors on the
params' device, which makes ``x / c`` an IEEE division on the card too.
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
        neg = -_lr_at(lr, state["step"])   # negated once, not per leaf
        upd = tree_map(lambda x: (neg * x.to(torch.float32)).to(x.dtype),
                       grads)
        return upd, {"step": state["step"] + 1}

    return Optimizer(init, update)


def _zeros_f32(params):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)


def momentum(lr: Schedule, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum (Nesterov's form with ``nesterov=True``)."""
    def init(params):
        device = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "m": _zeros_f32(params)}

    def update(grads, state, params):
        del params
        g = _lr_at(lr, state["step"])
        m = tree_map(lambda mi, gi: beta * mi + gi.to(torch.float32),
                     state["m"], grads)
        if nesterov:
            upd = tree_map(lambda mi, gi: (-g * (
                beta * mi + gi.to(torch.float32))).to(gi.dtype), m, grads)
        else:
            upd = tree_map(lambda mi, gi: (-g * mi).to(gi.dtype), m, grads)
        return upd, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam with bias correction; ``weight_decay`` adds
    ``weight_decay * params`` to the update (AdamW's decoupled form)."""
    def init(params):
        device = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "m": _zeros_f32(params), "v": _zeros_f32(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        g = _lr_at(lr, state["step"])
        m = tree_map(lambda mi, gi: b1 * mi + (1 - b1) * gi.to(
            torch.float32), state["m"], grads)
        v = tree_map(lambda vi, gi: b2 * vi + (1 - b2) * torch.square(
            gi.to(torch.float32)), state["v"], grads)
        s = step.to(torch.float32)
        c1 = 1 - torch.pow(b1, s)
        c2 = 1 - torch.pow(b2, s)

        def upd(mi, vi, pi):
            u = (mi / c1) / (torch.sqrt(vi / c2) + eps)
            if weight_decay:
                u = u + weight_decay * pi.to(torch.float32)
            return (-g * u).to(pi.dtype)

        return (tree_map(upd, m, v, params),
                {"step": step, "m": m, "v": v})

    return Optimizer(init, update)
