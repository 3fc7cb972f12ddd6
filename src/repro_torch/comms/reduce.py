"""WireOps: the reduction surface a codec's compressed collective targets
(PyTorch counterpart of ``repro.comms.reduce``).

* :meth:`SimWireOps.mean` — the aggregator's f32 group mean;
* :meth:`SimWireOps.sum` — dtype-preserving group sum (int32 payloads
  accumulate in int32);
* :meth:`SimWireOps.max` — group max of non-negative block statistics;
* :meth:`SimWireOps.count` — participants per group;
* :meth:`SimWireOps.gathered` — the group's encoded payloads stacked for
  a codec's own reduction (the sign vote);
* :meth:`SimWireOps.sparse_mean` — top-k (values, indices) payloads into
  the dense group mean.

Three implementations keep the exactness ladder: ``SimWireOps`` (in-array
reduces over the worker axis, the reference arithmetic), ``MeshWireOps``
(process-group collectives of the mesh executor's production lowering, on
the wire dtype; ``all_gather`` for the ragged forms) and ``ExactWireOps``
(gather the whole worker block, replay ``SimWireOps``, keep this rank's
row: bit for bit the sim's).

Masks are 0/1 participation weights.  Group results come back broadcast
over the worker rows of the input, as ``Topology.aggregate`` does.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import torch

from repro_torch.core.aggregators import (axis_weighted_mean,
                                          denominator_floor, named_axis_max,
                                          named_axis_sum,
                                          named_axis_weighted_mean)
from repro_torch.device import recip_f32
from repro_torch.kernels import comms as _kernels


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

    def sparse_mean(self, vals, idx, dense):
        """Top-k under sim: the decoded dense payload is already here, so
        its group mean is the legacy arithmetic, bit for bit; no kernel."""
        del vals, idx
        return self.mean(dense)


class MeshWireOps:
    """Process-group collectives of the mesh executor's production
    lowering: sums and maxes carry the wire dtype, ragged forms all-gather
    the encoded arrays.  ``axes`` are the event's syncing
    :class:`~repro_torch.launch.mesh.MeshAxes`; ``mask`` the (n,)
    participation mask every rank holds, ``widx`` this rank's worker
    index.  Each rank's arrays carry a leading worker axis of 1."""

    backend = "mesh"

    def __init__(self, axes, mask=None, widx: int = 0):
        self.axes = axes
        self.members = int(axes.size)
        self.mask = mask
        self.widx = int(widx)

    def _own_w(self, dtype):
        if self.mask is None:
            return None
        return self.mask.to(dtype)[self.widx]

    def mean(self, x):
        out = named_axis_weighted_mean(x.to(torch.float32),
                                       self._own_w(torch.float32),
                                       self.axes, torch.float32)
        return out.to(x.dtype)

    def sum(self, x):
        return named_axis_sum(x, self.axes, self._own_w(x.dtype))

    def max(self, x):
        return named_axis_max(x, self.axes, self._own_w(x.dtype))

    def count(self) -> Union[float, torch.Tensor]:
        if self.mask is None:
            return float(self.members)
        c = self.axes.psum(self._own_w(torch.float32).reshape(()))
        return torch.maximum(c, denominator_floor(torch.float32, c.device))

    def _member_mask(self):
        if self.mask is None:
            return None
        return self.axes.all_gather(
            self._own_w(torch.float32).reshape(1))          # (members,)

    def gathered(self, fn: Callable, *arrays):
        """All-gather each (1, ...) wire array over the syncing group to
        (members, ...), so the member axis lands at -2, call ``fn`` with the
        (members,) mask or None, and give its result a worker axis of 1."""
        g = [self.axes.all_gather(a) for a in arrays]
        return fn(*g, self._member_mask())[None]

    def sparse_mean(self, vals, idx, dense):
        """The top-k compressed collective: all-gather of the (values,
        indices) payloads, masked members' values zeroed, one fused
        decode-reduce kernel into the dense sum, then the participant
        mean."""
        vg = self.axes.all_gather(vals)
        ig = self.axes.all_gather(idx)
        wm = self._member_mask()
        if wm is not None:
            vg = vg * wm[:, None]
        k = vg.shape[-1]
        size = _prod(dense.shape[1:])
        acc = _kernels.topk_decode_reduce(
            vg.reshape(-1, k).contiguous(), ig.reshape(-1, k).contiguous(),
            size=size)
        count = self.count()
        # division rule: a constant count as a multiply by f32(1/count)
        acc = acc * recip_f32(count) if isinstance(count, float) \
            else acc / count
        return acc.reshape((1,) + tuple(dense.shape[1:])).to(dense.dtype)


class ExactWireOps:
    """The mesh executor's ``exact=True`` form: all-gather the whole worker
    block over ``world`` (every rank), replay :class:`SimWireOps` on it and
    keep this rank's row — bit for bit the sim trajectory for every codec,
    at n times the sync bytes (verification mode)."""

    backend = "sim"  # replays the sim arithmetic

    def __init__(self, world, widx: int, group_sizes: Sequence[int],
                 level: int, mask=None):
        self.world = world
        self.widx = int(widx)
        self.sim = SimWireOps(group_sizes, level, mask)

    def _gather(self, x):
        return self.world.all_gather(x)

    def _pick(self, out):
        return out[self.widx:self.widx + 1]

    def mean(self, x):
        return self._pick(self.sim.mean(self._gather(x)))

    def sum(self, x):
        return self._pick(self.sim.sum(self._gather(x)))

    def max(self, x):
        return self._pick(self.sim.max(self._gather(x)))

    def count(self):
        c = self.sim.count()
        return c if isinstance(c, float) else self._pick(c)

    def gathered(self, fn: Callable, *arrays):
        g = [self._gather(a) for a in arrays]
        return self._pick(self.sim.gathered(fn, *g))

    def sparse_mean(self, vals, idx, dense):
        return self._pick(self.sim.sparse_mean(
            self._gather(vals), self._gather(idx), self._gather(dense)))
