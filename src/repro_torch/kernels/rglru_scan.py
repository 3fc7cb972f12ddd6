"""The RG-LRU scan kernel: the wrapper over ``csrc/rglru_scan.cu``.

Counterpart of the Pallas TPU kernel ``repro.kernels.rglru_scan``:
:func:`rglru_scan` is the linear recurrence h_t = a_t h_{t-1} + b_t per
channel, from h = 0, over (Bt, S, W) float32 tensors.

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the output, and then either launches the CUDA kernel on
PyTorch's current stream (CUDA tensors) or runs the plain version
:func:`repro_torch.kernels.ref.rglru_ref` (CPU tensors, and only then).
Every launch adds one to :data:`launch_counts`.  It refuses inputs that
require grad while autograd records (:func:`repro_torch.kernels.refuse_grad`).
Each call is one kernel region for the analysis layer's recorder
(:func:`repro_torch.marks.kernel`), on either device, carrying
:func:`rglru_scan_work`.  The kernel reads packed (Bt, S, W) tensors;
other layouts are copied to contiguous ones first.  It computes the exact
recurrence, not the Pallas kernel's clamped log-space form (see
``csrc/rglru_scan.cu``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import marks
from repro_torch.kernels import ref, refuse_grad

_GRID_Y = 65535           # CUDA's limit on gridDim.y
_INT32 = 2**31 - 1

# launches of the CUDA kernel since the last reset_launch_counts()
launch_counts: Dict[str, int] = {"rglru_scan": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def rglru_scan_work(bt: int, s: int, w: int) -> marks.Work:
    """a and b read, h written, float32; a multiply and an add an
    element."""
    n = bt * s * w
    return marks.Work({"other": 2 * n}, 8 * n, 4 * n)


def _check(a, b) -> None:
    name = "rglru_scan"
    for what, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {what} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{name}: {what} must be 3-D (Bt, S, W), got "
                             f"shape {tuple(t.shape)}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: {what} is on {t.device}; the kernel "
                             "takes CUDA tensors and the plain version CPU "
                             "ones")
    if a.shape != b.shape:
        raise ValueError(f"{name}: a and b must have one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{name}: inputs on different devices {a.device} "
                         f"and {b.device}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (Bt, S, W) float32, 0 < a < 1 -> h (Bt, S, W) float32 with
    h_t = a_t h_{t-1} + b_t from h_0 = 0."""
    _check(a, b)
    refuse_grad("rglru_scan", a, b)
    with marks.kernel("rglru_scan", lambda: rglru_scan_work(*a.shape)):
        if a.device.type == "cpu":
            return ref.rglru_ref(a, b)[0]
        return _launch(a, b)


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    bt, s, w = a.shape
    h = torch.empty((bt, s, w), dtype=torch.float32, device=a.device)
    if h.numel() == 0:
        return h
    if bt > _GRID_Y or max(s, w) > _INT32:
        raise ValueError(f"rglru_scan: shape {tuple(a.shape)} is past the "
                         "kernel's grid")
    a, b = a.contiguous(), b.contiguous()
    from repro_torch.kernels._build import load
    fn = load("rglru_scan").hsgd_rglru_scan
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), bt, s, w, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan: CUDA kernel launch failed with "
                           f"cudaError {err}")
    launch_counts["rglru_scan"] += 1
    return h
