"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import sys
from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


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
