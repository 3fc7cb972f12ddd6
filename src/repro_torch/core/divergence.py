"""Upward / downward / global gradient divergences (paper Assumptions 1c/1d/2,
partition identity eq. (10), and Lemma 1/2 empirical expectations);
PyTorch counterpart of ``repro.core.divergence``.

All functions take per-worker gradients evaluated at a COMMON point w
(that is how the paper defines divergence), stacked as (n, dim) float
tensors (trees are flattened by the caller or via
``flatten_pytree_batch``).  The one-hot and group-size constants are built
on ``g``'s device in ``g``'s dtype.  The sums run in PyTorch's order, not
XLA's, so the results agree with the reference to float rounding, not bit
for bit.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.grouping import Grouping
from repro_torch.tree import tree_leaves, tree_map


def flatten_pytree_batch(grads) -> torch.Tensor:
    """Tree with leading worker dim -> (n, dim), leaves in sorted-key
    order (the reference's).  The CNN's conv weights are OIHW here and
    HWIO there, so their columns come in another order; every divergence
    is a sum of squares over ``dim`` and does not see the order."""
    leaves = [l.reshape(l.shape[0], -1) for l in tree_leaves(grads)]
    return torch.cat(leaves, dim=1)


def _sizes(grouping: Grouping, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(grouping.sizes, dtype=like.dtype,
                           device=like.device)


def _onehot(grouping: Grouping, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(grouping.onehot(), dtype=like.dtype,
                           device=like.device)


def global_divergence(g: torch.Tensor) -> torch.Tensor:
    """(1/n) sum_j ||g_j - mean||^2  — Assumption 2's LHS."""
    mean = g.mean(0)
    return ((g - mean) ** 2).sum(1).mean()


def group_means(g: torch.Tensor, grouping: Grouping) -> torch.Tensor:
    sums = _onehot(grouping, g) @ g                        # (N, dim)
    return sums / _sizes(grouping, g)[:, None]


def upward_divergence(g: torch.Tensor, grouping: Grouping) -> torch.Tensor:
    """sum_i (n_i/n) ||grad f_i - grad f||^2 — Assumption 1c's LHS.
    grad f is the n_i/n-weighted mean (paper eq. (2))."""
    gm = group_means(g, grouping)                          # (N, dim)
    w = _sizes(grouping, g) / grouping.n                   # (N,)
    gbar = (w[:, None] * gm).sum(0)
    return (w * ((gm - gbar) ** 2).sum(1)).sum()


def downward_divergences(g: torch.Tensor,
                         grouping: Grouping) -> torch.Tensor:
    """per-group (1/n_i) sum_{j in V_i} ||g_j - grad f_i||^2 — Assumption 1d.

    The per-worker group mean is scattered back with the one-hot transpose
    (``ohᵀ @ gm``) rather than a gather on the assignment vector, as the
    reference does: the same values (one-hot rows select exactly one
    mean)."""
    gm = group_means(g, grouping)                          # (N, dim)
    oh = _onehot(grouping, g)                              # (N, n)
    diffs = ((g - oh.T @ gm) ** 2).sum(1)                  # (n,)
    return (oh @ diffs) / _sizes(grouping, g)


def downward_divergence_avg(g: torch.Tensor,
                            grouping: Grouping) -> torch.Tensor:
    """sum_i (n_i/n) * eps_i^2-term = (1/n) sum_i sum_{j in V_i} ||.||^2."""
    w = _sizes(grouping, g) / grouping.n
    return (w * downward_divergences(g, grouping)).sum()


def partition_residual(g: torch.Tensor, grouping: Grouping) -> torch.Tensor:
    """eq. (10): global = upward + weighted downward (exact for uniform
    weights; returns the residual so tests can assert ~0)."""
    return (global_divergence(g)
            - upward_divergence(g, grouping)
            - downward_divergence_avg(g, grouping))


def partition_divergences(g: torch.Tensor, groupings) -> torch.Tensor:
    """The eq. (10) partition row ``[global, up_1, down_1, up_2, ...]`` for
    every grouping in ``groupings``, fused: center once (``y = g - mean``),
    then ``global = E||y_j||^2``, ``up = sum_i w_i ||gm_i(y)||^2`` and
    ``down = global - up`` (exact: the partition holds by construction).
    Centering first keeps the decomposition cancellation-free.  The naive
    per-term formulas above are the independent oracle."""
    y = g - g.mean(0)
    total = (y * y).sum(1).mean()
    out = [total]
    for grouping in groupings:
        gm = group_means(y, grouping)                      # (N, dim)
        w = _sizes(grouping, g) / grouping.n
        up = (w * (gm * gm).sum(1)).sum()
        out += [up, total - up]
    return torch.stack(out)


def _lift_matrices(groupings):
    """For NESTED groupings (outermost first — an H-SGD hierarchy's
    ``level_groupings``), the (N_l, N_fin) maps taking finest-level group
    means to each coarser level's group means, in numpy float64.  None
    when the groupings are not nested (independent partitions: no lift
    exists)."""
    fin = groupings[-1]
    ohf = np.asarray(fin.onehot(), np.float64)             # (Nf, n)
    lifts = []
    for g in groupings[:-1]:
        counts = np.asarray(g.onehot(), np.float64) @ ohf.T  # workers in both
        if (np.count_nonzero(counts, axis=0) != 1).any():
            return None
        lifts.append(counts / np.asarray(g.sizes, np.float64)[:, None])
    return lifts


def partition_constants(groupings, device) -> Dict:
    """The float32 constants :func:`partition_divergences_tree` needs for
    ``groupings``, on ``device``: each grouping's one-hot and size weights,
    and the lifts of nested groupings.  Build them once and pass them in
    where the row is taken repeatedly, so that no host-to-device copy (a
    host sync on a card) runs per call."""
    f32 = dict(dtype=torch.float32, device=device)
    consts = {
        "onehot": [torch.as_tensor(g.onehot(), **f32) for g in groupings],
        "sizes": [torch.as_tensor(g.sizes, **f32) for g in groupings],
        "weights": [torch.as_tensor(g.sizes, **f32) / g.n
                    for g in groupings],
        "lifts": None,
    }
    lifts = _lift_matrices(groupings) if groupings else None
    if lifts is not None:
        consts["lifts"] = [torch.as_tensor(l, **f32) for l in lifts]
    return consts


def partition_divergences_tree(params, groupings,
                               consts: Optional[Dict] = None
                               ) -> torch.Tensor:
    """:func:`partition_divergences` evaluated leaf by leaf on a tree with
    a leading worker dim, in float32 — the sum-of-squares terms are
    additive over leaves, so the (n, dim) concatenation never
    materializes.

    For nested groupings only the FINEST level touches the (n, dim) block:
    its group means come from one contraction, the global mean and every
    coarser level's means are weighted combinations of those (tiny), and
    the only other full-size pass is the centered-norm reduction for the
    global term.  Non-nested groupings fall back to one contraction per
    level.  ``consts`` is :func:`partition_constants` for these groupings
    on the leaves' device (built here when None)."""
    leaves = [l.reshape(l.shape[0], -1).to(torch.float32)
              for l in tree_leaves(params)]
    dev = leaves[0].device
    if consts is None:
        consts = partition_constants(groupings, dev)
    # the sums start at their first term (no zeros to add it to: a
    # launch less per term on the card, and 0 + t == t in float32)
    total = None
    ups = [None] * len(groupings)

    def acc(s, t):
        return t if s is None else s + t

    def means(x, i):
        return (consts["onehot"][i] @ x) / consts["sizes"][i][:, None]

    def up_term(gm_centered, i):
        return (consts["weights"][i]
                * (gm_centered * gm_centered).sum(1)).sum()

    lifts = consts["lifts"]
    for x in leaves:
        if lifts is None:
            y = x - x.mean(0)
            total = acc(total, (y * y).sum(1).mean())
            for i in range(len(groupings)):
                ups[i] = acc(ups[i], up_term(means(y, i), i))
            continue
        gmf = means(x, -1)                                 # (Nf, dim)
        xbar = (consts["weights"][-1][:, None] * gmf).sum(0)  # global mean
        total = acc(total, ((x - xbar) ** 2).sum(1).mean())
        gmfc = gmf - xbar
        ups[-1] = acc(ups[-1], up_term(gmfc, -1))
        for i, lift in enumerate(lifts):
            ups[i] = acc(ups[i], up_term(lift @ gmfc, i))
    out = [total]
    for up in ups:
        out += [up, total - up]
    return torch.stack(out)


def divergence_stack(g: torch.Tensor, grouping: Grouping) -> torch.Tensor:
    """All four divergence summaries as ONE stacked tensor
    ``[global, upward, downward_avg, downward_max]``, so callers pay one
    device→host transfer instead of four."""
    dd = downward_divergences(g, grouping)
    w = _sizes(grouping, g) / grouping.n
    return torch.stack([
        global_divergence(g),
        upward_divergence(g, grouping),
        (w * dd).sum(),
        dd.max(),
    ])


def all_divergences(g: torch.Tensor, grouping: Grouping) -> Dict[str, float]:
    """Host-side divergence summary, with one device→host transfer of the
    stacked four (``divergence_stack``)."""
    vals = divergence_stack(g, grouping).tolist()
    return {
        "global": float(vals[0]),
        "upward": float(vals[1]),
        "downward_avg": float(vals[2]),
        "downward_max": float(vals[3]),
    }


def per_worker_grads(loss_fn, params, batches) -> torch.Tensor:
    """Gradients of every worker's loss at a COMMON params point.
    loss_fn(params, batch) -> (loss, aux); batches: tree with leading
    worker dim (numpy or tensors; moved to the params' device).  Returns
    (n, dim)."""
    dev = tree_leaves(params)[0].device
    batches = tree_map(lambda v: torch.as_tensor(v).to(dev), batches)
    gfn = torch.func.grad(loss_fn, has_aux=True)
    grads, _ = torch.func.vmap(gfn, in_dims=(None, 0))(params, batches)
    return flatten_pytree_batch(grads)
