"""Three-term roofline of one recorded call, priced for an NVIDIA H100
(counterpart of ``repro.roofline.analysis``).

  compute term    = sum over FLOP classes of FLOPs / that class's rate
  memory term     = bytes / HBM rate
  collective term = intra-node bytes / NVLink rate
                    + cross-node bytes / network rate

The reference prices compiled HLO per TPU chip; the port prices the eager
program it actually runs: one call under the analysis layer's recorder,
its ops priced by :mod:`repro_torch.roofline.op_cost`.  One program runs
on one card, so every figure is per card.  FLOPs are split by class
because the port runs its float32 products with TF32 off, at 1/15 of the
bf16 rate: one peak would put every float32 bound 15x too low.  The
figures are bounds (the least time the card could take), not
measurements.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.analysis.walker import record
from repro_torch.marks import FLOP_CLASSES, Work
from repro_torch.roofline.op_cost import COLLECTIVES, price


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM5 80 GB: dense rates (no sparsity) at its 700 W
    power limit; a card set lower runs slower under load."""
    # NVIDIA H100 Tensor Core GPU datasheet (SXM): bf16 / fp16 tensor-core
    # products, dense
    peak_flops: float = 989e12
    # same datasheet: TF32 tensor-core products, dense (float32 products
    # while torch.backends.cuda.matmul.allow_tf32 is on)
    tf32_flops: float = 494.7e12
    # same datasheet: float32 outside the tensor cores (float32 products
    # with TF32 off, and every FLOP that is not a product)
    f32_flops: float = 67e12
    # same datasheet: HBM3 bandwidth and capacity
    hbm_bw: float = 3.35e12
    hbm_bytes: float = 80e9
    # same datasheet: NVLink 4, 900 GB/s both ways, so 450 GB/s a direction
    intra_bw: float = 450e9
    # NVIDIA DGX H100 datasheet: one 400 Gb/s ConnectX-7 port a GPU
    cross_bw: float = 50e9

    def rate(self, cls: str, tf32: bool = False) -> float:
        """FLOP/s of FLOP class ``cls`` (:data:`~repro_torch.marks.
        FLOP_CLASSES`); float32 products at the TF32 rate only when TF32
        was on."""
        if cls == "bf16":
            return self.peak_flops
        if cls == "f32" and tf32:
            return self.tf32_flops
        if cls in FLOP_CLASSES:
            return self.f32_flops
        raise ValueError(f"unknown FLOP class {cls!r}: want one of "
                         f"{FLOP_CLASSES}")


def work_bound(work: Work, hw: HW = HW(),
               tf32: bool = False) -> Tuple[float, str]:
    """Least seconds of one kernel call's ``work``: the larger of its bytes
    over the memory rate and its FLOPs over their classes' rates, and
    which of the two bounds it ("bytes" or "operations").  A call of
    stages (``work.stages``) takes the sum of their bounds, and is bound
    by what bounds its longest stage."""
    if work.stages:
        parts = [work_bound(w, hw, tf32) for w in work.stages]
        return sum(t for t, _ in parts), max(parts)[1]
    t_bytes = work.bytes / hw.hbm_bw
    t_ops = sum(f / hw.rate(c, tf32) for c, f in work.flops.items())
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


@dataclasses.dataclass
class RooflineReport:
    name: str
    flops_per_chip: float
    bytes_per_chip: float
    coll_intra: float
    coll_cross: float
    coll_by_kind: Dict[str, float]
    peak_memory_bytes: Optional[float]
    hw: HW = dataclasses.field(default_factory=HW)
    flops_by_class: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    tf32: bool = False                 # TF32 on while the call ran
    regions: Dict[str, int] = dataclasses.field(default_factory=dict)
    model_flops: Optional[float] = None

    def __post_init__(self):
        total = sum(self.flops_by_class.values())
        if not math.isclose(total, self.flops_per_chip, rel_tol=1e-12,
                            abs_tol=1e-6):
            raise ValueError(f"{self.name}: flops_by_class sums to {total}, "
                             f"not flops_per_chip {self.flops_per_chip}")

    @property
    def compute_s(self) -> float:
        return sum(f / self.hw.rate(c, self.tf32)
                   for c, f in self.flops_by_class.items())

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return (self.coll_intra / self.hw.intra_bw
                + self.coll_cross / self.hw.cross_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """The perfectly-overlapped bound of the call: the largest term
        (their sum is the no-overlap estimate)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> Optional[float]:
        """Model FLOPs (6*N*D or 2*N*D) over the FLOPs priced, as the
        reference's dry run computes it (``dryrun.py:265-269``)."""
        if self.model_flops is None:
            return None
        return self.model_flops / max(self.flops_per_chip, 1)

    def asdict(self) -> Dict:
        return {
            "name": self.name,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_intra_bytes": self.coll_intra,
            "coll_cross_bytes": self.coll_cross,
            "coll_by_kind": self.coll_by_kind,
            "peak_memory_bytes": self.peak_memory_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s_overlapped": self.step_s,
            "flops_by_class": self.flops_by_class,
            "tf32": self.tf32,
            "regions": self.regions,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
        }


def _first_tensor(obj) -> Optional[torch.Tensor]:
    """The first tensor in nested dicts, lists, tuples and dataclasses."""
    if isinstance(obj, torch.Tensor):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for child in obj:
            t = _first_tensor(child)
            if t is not None:
                return t
    return None


def analyze_program(name: str, fn, *args: Any, hw: HW = HW(),
                    top_axis: str = "pod",
                    model_flops: Optional[float] = None,
                    **kwargs: Any) -> RooflineReport:
    """Record one call ``fn(*args, **kwargs)`` on deep copies of its
    arguments (so a call that updates its state in place leaves the
    caller's alone), and price it.  ``top_axis`` is the hierarchy's top
    mesh axis (the reference's ``pod_size``: collectives over it are
    cross-node); ``model_flops`` gives the report its ``useful_ratio``.

    ``peak_memory_bytes`` is ``torch.cuda.max_memory_allocated`` over the
    call, reset after the copies are made, when the arguments are on the
    card (the copies, the originals and the call's temporaries); None on
    the CPU."""
    args, kwargs = copy.deepcopy((args, kwargs))
    t = _first_tensor((args, kwargs))
    card = t is not None and t.device.type == "cuda"
    if card:
        torch.cuda.synchronize(t.device)
        torch.cuda.reset_peak_memory_stats(t.device)
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    summary = record(fn, *args, **kwargs)
    peak = None
    if card:
        torch.cuda.synchronize(t.device)
        peak = float(torch.cuda.max_memory_allocated(t.device))
    c = price(summary.ops, top_axis)
    return RooflineReport(
        name=name, flops_per_chip=sum(c.flops.values()),
        bytes_per_chip=c.bytes, coll_intra=c.coll_intra,
        coll_cross=c.coll_cross,
        coll_by_kind={k: c.coll_by_kind[k] for k in COLLECTIVES},
        peak_memory_bytes=peak, hw=hw, flops_by_class=c.flops, tf32=tf32,
        regions=c.regions, model_flops=model_flops)


def combine_train_steps(reports: Dict[str, RooflineReport], G: int,
                        I: int) -> Dict[str, float]:
    """Amortized H-SGD step over one global period:
    (G - G/I) pure-local + (G/I - 1) local-sync + 1 global-sync steps.
    M=1 hierarchies (fsdp mapping) have no local sync: local stands in."""
    lsync = reports.get("local_sync", reports["local"])
    n_local = G - G // I
    n_lsync = G // I - 1
    out = {}
    for term in ("compute_s", "memory_s", "collective_s"):
        tot = (n_local * getattr(reports["local"], term)
               + n_lsync * getattr(lsync, term)
               + getattr(reports["global_sync"], term))
        out[term] = tot / G
    out["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                          key=lambda t: out[t])
    return out


def model_flops_per_step(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for train (fwd+bwd), 2*N*D per generated/processed
    token at inference. MoE: active params only."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq
