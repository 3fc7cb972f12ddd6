"""Plain PyTorch versions of the port's kernels (PyTorch counterpart of
``repro.kernels.ref``).

They run on any device.  The kernel wrappers in
:mod:`repro_torch.kernels.comms` use them for CPU tensors, the CPU tests
hold them bitwise against the JAX package, and ``chip_smoke.py`` holds
each CUDA kernel bitwise against them on the card.  Every operation here
is chosen so that CPU, card and the jitted reference round identically:

* Rounding rule: ``torch.round`` rounds half to even, like ``jnp.round``.
* Division rule: the scale is ``amax * f32(1/127)`` (XLA's folded form of
  ``amax / 127``, see :func:`repro_torch.device.recip_f32`), and ``inv``
  is a true division ``1 / scale``, then ``x * inv`` — never ``x / scale``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import recip_f32

INV127 = recip_f32(127.0)


def _blocked(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """(R, C) -> (R, nb, block) zero-padded float32 view, plus nb."""
    r, c = x.shape
    nb = -(-c // block)
    xp = F.pad(x.to(torch.float32), (0, nb * block - c))
    return xp.reshape(r, nb, block), nb


def _inv(scale: torch.Tensor) -> torch.Tensor:
    """1/scale by true division, 0 where the scale is 0 (q = 0 there)."""
    inv = torch.ones_like(scale) / scale
    return torch.where(scale > 0, inv, torch.zeros_like(scale))


def int8_ref(x: torch.Tensor, block: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block max-scale int8: (q int8 (R, C), scale f32 (R, nb),
    roundtrip f32 (R, C))."""
    r, c = x.shape
    xb, nb = _blocked(x, block)
    scale = xb.abs().amax(dim=-1) * INV127                     # (R, nb)
    q = torch.clamp(torch.round(xb * _inv(scale)[..., None]), -127, 127)
    rt = (q * scale[..., None]).reshape(r, nb * block)[:, :c]
    q = q.to(torch.int8).reshape(r, nb * block)[:, :c]
    return q.contiguous(), scale, rt.contiguous()


def int8_dequant_ref(q: torch.Tensor, scale: torch.Tensor,
                     block: int) -> torch.Tensor:
    """``q * scale`` per block: (R, C) int8 and (R, nb) f32 -> (R, C) f32."""
    r, c = q.shape
    qb, nb = _blocked(q, block)
    y = (qb * scale[..., None]).reshape(r, nb * block)[:, :c]
    return y.contiguous()


def int8_scale_quant_ref(x: torch.Tensor, scale: torch.Tensor,
                         block: int) -> torch.Tensor:
    """Shared-scale int8: q = clip(round(x * (1/scale))) per block, with a
    zero scale mapping to q = 0."""
    r, c = x.shape
    xb, nb = _blocked(x, block)
    q = torch.clamp(torch.round(xb * _inv(scale)[..., None]), -127, 127)
    return q.to(torch.int8).reshape(r, nb * block)[:, :c].contiguous()
