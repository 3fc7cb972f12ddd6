"""WireOps: the reduction surface a codec's compressed collective targets
(PyTorch counterpart of ``repro.comms.reduce``; this slice ports the sim
form only — the mesh forms come with ROADMAP A8).

* :meth:`SimWireOps.mean` — the aggregator's f32 group mean;
* :meth:`SimWireOps.sum` — dtype-preserving group sum (int32 payloads
  accumulate in int32);
* :meth:`SimWireOps.max` — group max of non-negative block statistics;
* :meth:`SimWireOps.count` — participants per group;
* :meth:`SimWireOps.gathered` — the group's encoded payloads stacked for
  a codec's own reduction (the sign vote).

Masks are 0/1 participation weights.  Group results come back broadcast
over the worker rows of the input, as ``Topology.aggregate`` does.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import torch

from repro_torch.core.aggregators import (axis_weighted_mean,
                                          denominator_floor)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


class SimWireOps:
    """In-array reductions over the leading worker axis.  ``group_sizes``
    + ``level`` define the member axis exactly as
    ``UniformTopology.aggregate`` does."""

    backend = "sim"

    def __init__(self, group_sizes: Sequence[int], level: int, mask=None):
        self.gs = tuple(int(g) for g in group_sizes)
        self.level = int(level)
        self.mask = mask
        self.members = _prod(self.gs[self.level - 1:])
        self.outer = _prod(self.gs) // self.members

    def _axes(self) -> Tuple[int, ...]:
        return tuple(range(self.level - 1, len(self.gs)))

    def _shaped(self, x):
        return x.reshape(self.gs + tuple(x.shape[1:]))

    def _wr(self, shaped, dtype):
        if self.mask is None:
            return None
        w = torch.as_tensor(self.mask, device=shaped.device).to(dtype)
        return w.reshape(self.gs + (1,) * (shaped.ndim - len(self.gs)))

    @staticmethod
    def _restore(out, shaped_shape, flat_shape):
        return out.expand(shaped_shape).reshape(flat_shape)

    def mean(self, x):
        """``UniformTopology.aggregate`` for the default f32 mean."""
        shaped = self._shaped(x)
        wr = self._wr(shaped, torch.float32)
        out = axis_weighted_mean(shaped.to(torch.float32), wr, self._axes(),
                                 torch.float32)
        return self._restore(out.to(x.dtype), shaped.shape, x.shape)

    def sum(self, x):
        """Dtype-preserving masked group sum.  int32 rule: ``torch.sum`` of
        an int32 tensor returns int64 unless told otherwise, so the dtype
        is passed explicitly and int32 payloads accumulate in int32."""
        shaped = self._shaped(x)
        shape = shaped.shape
        wr = self._wr(shaped, x.dtype)
        if wr is not None:
            shaped = shaped * wr
        out = shaped.sum(dim=self._axes(), keepdim=True, dtype=x.dtype)
        return self._restore(out, shape, x.shape)

    def max(self, x):
        """Masked group max of NON-NEGATIVE statistics (block amax)."""
        shaped = self._shaped(x)
        shape = shaped.shape
        wr = self._wr(shaped, x.dtype)
        if wr is not None:
            shaped = shaped * wr
        out = shaped.amax(dim=self._axes(), keepdim=True)
        return self._restore(out, shape, x.shape)

    def count(self) -> Union[float, torch.Tensor]:
        """Participants per group: a Python float when unmasked (no device
        work), else a per-row (n, 1) f32 tensor floored away from 0."""
        if self.mask is None:
            return float(self.members)
        m = torch.as_tensor(self.mask).to(torch.float32).reshape(self.gs)
        c = m.sum(dim=self._axes(), keepdim=True, dtype=torch.float32)
        c = c.expand(self.gs).reshape(-1, 1)
        return torch.maximum(c, denominator_floor(torch.float32, c.device))

    def gathered(self, fn: Callable, *arrays):
        """Group-stack the (n, ...) wire arrays to (outer, members, ...),
        call ``fn(*stacked, member_mask)`` (member axis at -2; the mask is
        an (outer, members) f32 tensor or None) and broadcast its
        (outer, ...) result back over the member rows."""
        g = [a.reshape((self.outer, self.members) + tuple(a.shape[1:]))
             for a in arrays]
        wmask = None
        if self.mask is not None:
            wmask = torch.as_tensor(self.mask, device=arrays[0].device).to(
                torch.float32).reshape(self.outer, self.members)
        out = fn(*g, wmask)
        out = out[:, None].expand((self.outer, self.members)
                                  + tuple(out.shape[1:]))
        return out.reshape((self.outer * self.members,)
                           + tuple(out.shape[2:]))
