"""Wire accounting: what a sync schedule moves, in bytes (PyTorch
counterpart of ``repro.comms.wire``).

Computed statically from the codec's wire-array specs, never from device
values.  Cost model: a level-ℓ sync moves one encoded payload across every
tree edge at tiers ℓ..M on the way up — ``sum_{j=ℓ}^{M} n_j`` payloads with
``n_j = prod(group_sizes[:j])``; uplink only.  For a ``GroupedTopology`` a
global sync moves ``n + N`` payloads and a (possibly partial) group sync
one payload per participating worker.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.topology import GroupedTopology, SyncEvent, Topology


def dtype_name(dtype) -> str:
    """'float32' for torch.float32 (the reference's dtype names)."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class WireArray:
    """One array of a codec's wire format (per worker, per sync)."""
    name: str
    shape: Tuple[int, ...]
    dtype: str

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * \
            getattr(torch, self.dtype).itemsize


class WireStats:
    """Per-level byte accounting for one (topology, payload spec) pair.

    payload: the codec wire arrays ONE worker ships at ONE sync event.
    ``f32_bytes`` is the uncompressed f32 baseline for the same element
    count, so ``compression_ratio`` is the codec's payload reduction."""

    def __init__(self, topology: Topology, payload: Tuple[WireArray, ...],
                 n_elements: int):
        self.topology = topology
        self.payload = tuple(payload)
        self.n_elements = int(n_elements)

    @property
    def payload_bytes(self) -> int:
        return sum(a.nbytes for a in self.payload)

    @property
    def f32_bytes(self) -> int:
        return 4 * self.n_elements

    @property
    def wire_dtypes(self) -> Tuple[str, ...]:
        """Sorted distinct dtype names of the declared wire payload."""
        return tuple(sorted({a.dtype for a in self.payload}))

    @property
    def compression_ratio(self) -> float:
        return self.f32_bytes / max(self.payload_bytes, 1)

    def payload_count(self, event: SyncEvent) -> int:
        """Encoded payloads crossing the wire (uplink) for one event."""
        topo = self.topology
        spec = getattr(topo, "spec", None)
        if spec is not None:
            return sum(spec.n_at_level(j)
                       for j in range(event.level, spec.num_levels + 1))
        if isinstance(topo, GroupedTopology):
            sizes = np.asarray(topo.grouping.sizes)
            if event.level == 1:
                return int(sizes.sum()) + topo.grouping.N
            if event.groups is None:
                return int(sizes.sum())
            return int(sizes[np.asarray(event.groups)].sum())
        return topo.n

    def bytes_for_event(self, event: Optional[SyncEvent]) -> int:
        if event is None:
            return 0
        return self.payload_count(event) * self.payload_bytes

    def step_bytes(self, T: int, t0: int = 0) -> List[int]:
        """Bytes moved by the sync (if any) after each of steps t0..t0+T-1."""
        return [self.bytes_for_event(self.topology.event_at(t))
                for t in range(t0, t0 + T)]

    def per_level(self) -> Dict[str, Dict[str, int]]:
        """Per-level traffic from the events of one global period, as
        fired: partial-group events are costed as the mean over the
        level's events, so the summary agrees with the per-step history."""
        G = self.topology.periods[0]
        events: Dict[int, List[SyncEvent]] = {}
        for t in range(G):
            ev = self.topology.event_at(t)
            if ev is not None:
                events.setdefault(ev.level, []).append(ev)

        def mean(vals):
            m = sum(vals) / len(vals)
            return int(m) if float(m).is_integer() else m

        return {f"L{l}": {
            "payloads_per_sync": mean([self.payload_count(e) for e in evs]),
            "bytes_per_sync": mean([self.bytes_for_event(e) for e in evs]),
            "syncs_per_period": len(evs),
            "period": self.topology.periods[l - 1],
        } for l, evs in sorted(events.items())}

    def summary(self, T: Optional[int] = None) -> Dict:
        """JSON-able report; with ``T``, adds schedule totals over T steps."""
        out = {
            "payload": [dataclasses.asdict(a) for a in self.payload],
            "payload_bytes_per_worker": self.payload_bytes,
            "f32_bytes_per_worker": self.f32_bytes,
            "compression_ratio": round(self.compression_ratio, 3),
            "per_level": self.per_level(),
        }
        if T:
            sb = self.step_bytes(T)
            out["steps"] = T
            out["total_bytes"] = int(sum(sb))
            out["bytes_per_step"] = sum(sb) / T
        return out
