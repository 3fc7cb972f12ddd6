"""Rematerialization: ``jax.checkpoint``'s counterpart.

:func:`checkpoint` runs a body forward and keeps only its inputs for the
backward, which runs the body again (through ``torch.func.vjp``) and
differentiates that second run: what autograd would otherwise keep of the
body's inside (a pattern unit's activations, an attention chunk's
probabilities) is never saved.  The values are the body's own, so the
loss is unchanged and the gradients are those of plain autograd, up to
the order in which a gradient that several bodies share is summed (an
encoder-decoder's memory, read by every decoder layer).

It is one ``torch.autograd.Function`` with ``setup_context`` and a
generated vmap rule, so it runs under plain autograd, under
``torch.func.grad`` and under ``vmap(grad)`` (the H-SGD executors' local
update), on plain tensors and on DTensors.  ``torch.utils.checkpoint``
cannot stand in: functorch's transforms refuse its saved-tensor hooks.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

from repro_torch.device import DTENSOR_FLATTENS_SHARDED
from repro_torch.tree import tree_flatten


class _Checkpoint(torch.autograd.Function):
    """``run(*tensors) -> tuple of tensors``, saving only ``tensors``."""
    generate_vmap_rule = True

    @staticmethod
    def forward(run, *tensors):
        return run(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        # detached: the caller's tape records nothing of the second run.
        # torch.func.grad runs its backward with create_graph=True, which
        # would otherwise keep every intermediate of it alive to the end of
        # the step; grad mode stays as the caller set it, since some
        # backward formulas depend on it (silu's), and vjp differentiates
        # its own level.  torch 2.11's DTensor needs the output gradients
        # contiguous (a sequence-sharded chunk's backward views them),
        # 2.13's must not have them copied (a pinned fsdp layout's local
        # view breaks)
        saved = [t.detach() for t in ctx.saved_tensors]
        grads = tuple(None if g is None else g.detach()
                      if DTENSOR_FLATTENS_SHARDED
                      else g.detach().contiguous() for g in grads)
        diff = [i for i, t in enumerate(saved) if t.is_floating_point()]

        def again(*floats):
            full = list(saved)
            for i, t in zip(diff, floats):
                full[i] = t
            return ctx.run(*full)

        _, vjp = torch.func.vjp(again, *(saved[i] for i in diff))
        got = vjp(grads)
        out: List[Any] = [None] * len(saved)
        for i, g in zip(diff, got):
            out[i] = g
        return (None, *out)


def checkpoint(body: Callable, *args):
    """``body(*args)``, its inside recomputed in the backward.  ``args``
    and what ``body`` returns are trees of tensors (dicts, tuples, lists);
    a leaf that is not a tensor is passed to ``body`` as it is.  Gradients
    flow to the floating-point tensors of ``args``."""
    leaves, tdef = tree_flatten(args)
    at = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    out_def: List[Any] = []

    def run(*tensors):
        full = list(leaves)
        for i, t in zip(at, tensors):
            full[i] = t
        outs, odef = tree_flatten(body(*tdef.unflatten(full)))
        out_def[:] = [odef]
        return tuple(outs)

    outs = _Checkpoint.apply(run, *(leaves[i] for i in at))
    return out_def[0].unflatten(outs)
