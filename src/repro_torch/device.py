"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import sys
from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]

# whether this torch's DTensor flattens two dims whose inner one is
# sharded (2.13 does, with a strided shard; 2.11 raises; 2.12 is
# untried).  An older one needs two work-arounds in the dry run's
# training programs: ``models.layers.token_first`` and the contiguous
# output gradients of ``models.remat``.
DTENSOR_FLATTENS_SHARDED = torch.torch_version.TorchVersion(
    torch.__version__) >= (2, 13)


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    there is none (the port never carries on on the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


def recip_f32(c: float) -> float:
    """The float32 reciprocal of a constant, as a Python float.

    Division rule: XLA folds ``x / c`` for a constant ``c`` into
    ``x * f32(1/c)``, so that is the arithmetic the JAX package runs under
    jit; PyTorch's CUDA ``x / c`` does the same while its CPU ``x / c``
    divides.  Where the reference divides by a constant, the port
    multiplies by this value on every device, so CPU, card and reference
    agree bitwise."""
    return float(np.float32(1.0) / np.float32(c))


def is_dtensor(x) -> bool:
    """Is ``x`` a ``torch.distributed.tensor.DTensor``?  Without importing
    that module (1.4 s): none exists until something has imported it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def dtensor_of(x):
    """The DTensor that ``x`` is, or that functorch's wrappers (``vmap``,
    ``grad``) hold inside it; None for anything else."""
    if sys.modules.get("torch.distributed.tensor") is None:
        return None
    from torch._C import _functorch
    while _functorch.is_functorch_wrapped_tensor(x):
        x = _functorch.get_unwrapped(x)
    return x if is_dtensor(x) else None


def dtensor_layout(x):
    """``(dtensor, placements)``: the DTensor that ``x`` is or that
    functorch's wrappers hold inside it, and its placements in ``x``'s own
    dims (a ``vmap`` level's batch dim taken out, so ``Shard(d)`` names
    dim ``d`` of ``x`` as the caller sees it).  None when there is no
    DTensor, or when a mapped batch dim is itself sharded."""
    if sys.modules.get("torch.distributed.tensor") is None:
        return None
    from torch._C import _functorch
    from torch.distributed.tensor import Shard
    dims = list(range(x.ndim))          # x's dims at each physical dim
    while _functorch.is_functorch_wrapped_tensor(x):
        if _functorch.is_batchedtensor(x):
            dims.insert(_functorch.maybe_get_bdim(x), None)
        x = _functorch.get_unwrapped(x)
    if not is_dtensor(x):
        return None
    out = []
    for p in x.placements:
        if p.is_shard():
            if dims[p.dim] is None:
                return None
            p = Shard(dims[p.dim])
        out.append(p)
    return x, out


def redistribute(x, placements):
    """``x``, a DTensor or one under functorch's wrappers, moved to
    ``placements`` (in ``x``'s own dims, :func:`dtensor_layout`), its
    gradient moved back to ``x``'s placements (a partial sum's to
    replicated); anything else, or a DTensor already so placed, comes
    back as it is.
    ``DTensor.redistribute`` cannot reach a DTensor under the wrappers of
    ``vmap`` and ``grad`` (the H-SGD executors' local update); this can."""
    layout = dtensor_layout(x)
    if layout is None or list(placements) == layout[1]:
        return x
    from torch.distributed.tensor import Replicate
    # the gradient of a partial sum is whole on every rank
    back = [Replicate() if p.is_partial() else p for p in layout[1]]
    return _Redistribute.apply(x, layout[0].device_mesh, list(placements),
                               back)


class _Redistribute(torch.autograd.Function):
    """A DTensor ``x`` to placements ``want`` on ``mesh``, its gradient
    back to ``back`` (both in ``x``'s dims at the level of the call).  The
    ``vmap`` rule unwraps a batch level and shifts the placements past
    its batch dim, so that the forward meets the DTensor itself."""

    @staticmethod
    def forward(x, mesh, want, back):
        return x.redistribute(mesh, want)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.want, ctx.back = inputs

    @staticmethod
    def backward(ctx, g):
        return (_Redistribute.apply(g, ctx.mesh, ctx.back, ctx.want), None,
                None, None)

    @staticmethod
    def vmap(info, in_dims, x, mesh, want, back):
        bdim = in_dims[0]
        if bdim is None:
            return _Redistribute.apply(x, mesh, want, back), None
        from torch.distributed.tensor import Shard

        def past(ps):
            return [Shard(p.dim + (p.dim >= bdim)) if p.is_shard() else p
                    for p in ps]
        return _Redistribute.apply(x, mesh, past(want), past(back)), bdim
