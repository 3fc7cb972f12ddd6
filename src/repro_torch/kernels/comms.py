"""The int8 wire codec's kernels: wrappers over ``csrc/int8_codec.cu``.

Counterparts of the Pallas TPU kernels in ``repro.kernels.comms``:

* :func:`int8_quantize` / :func:`int8_dequantize` — per-block symmetric
  int8 (block max-scale), one f32 scale per block;
* :func:`int8_scale_quantize` — quantize against a caller-supplied (shared
  group-max) scale, the encode side of the int8 compressed allreduce.

Each wrapper checks its inputs and raises on anything its kernel does not
take, allocates its outputs, and then either launches the CUDA kernel on
PyTorch's current stream (a CUDA tensor) or runs the plain version from
:mod:`repro_torch.kernels.ref` (a CPU tensor, and only then).  Every launch
adds one to :data:`launch_counts`.  The block size is part of the wire
format: callers pass their codec's block, nothing shrinks it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref

# launches of each CUDA kernel since the last reset_launch_counts()
launch_counts: Dict[str, int] = {
    "int8_quantize": 0, "int8_dequantize": 0, "int8_scale_quantize": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check(name: str, what: str, t: torch.Tensor, dtype: torch.dtype,
           shape=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: {what} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if t.ndim != 2:
        raise ValueError(f"{name}: {what} must be 2-D (rows, cols), got "
                         f"shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: {what} is on {t.device}; the kernel "
                         "takes CUDA tensors and the plain version CPU ones")


def _check_block(name: str, block: int) -> int:
    block = int(block)
    if block <= 0:
        raise ValueError(f"{name}: block must be positive, got {block}")
    return block


def _same_device(name: str, *ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: inputs on different devices "
                         f"{[str(t.device) for t in ts]}")


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    from repro_torch.kernels._build import load
    fn = getattr(load("int8_codec"), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")
    launch_counts[name] += 1


def int8_quantize(x: torch.Tensor, *, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x f32 (R, C) -> (q int8 (R, C), scale f32 (R, ceil(C/block)))."""
    name = "int8_quantize"
    block = _check_block(name, block)
    _check(name, "x", x, torch.float32)
    if x.device.type == "cpu":
        q, scale, _ = ref.int8_ref(x, block)
        return q, scale
    r, c = x.shape
    q = torch.empty((r, c), dtype=torch.int8, device=x.device)
    scale = torch.empty((r, -(-c // block)), dtype=torch.float32,
                        device=x.device)
    if x.numel():
        _launch(name, "hsgd_int8_quantize", x.device, x.data_ptr(),
                q.data_ptr(), scale.data_ptr(), r, c, block)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor, *,
                    block: int = 256) -> torch.Tensor:
    """(q int8 (R, C), scale f32 (R, ceil(C/block))) -> x f32 (R, C)."""
    name = "int8_dequantize"
    block = _check_block(name, block)
    _check(name, "q", q, torch.int8)
    r, c = q.shape
    _check(name, "scale", scale, torch.float32, (r, -(-c // block)))
    _same_device(name, q, scale)
    if q.device.type == "cpu":
        return ref.int8_dequant_ref(q, scale, block)
    y = torch.empty((r, c), dtype=torch.float32, device=q.device)
    if q.numel():
        _launch(name, "hsgd_int8_dequantize", q.device, q.data_ptr(),
                scale.data_ptr(), y.data_ptr(), r, c, block)
    return y


def int8_scale_quantize(x: torch.Tensor, scale: torch.Tensor, *,
                        block: int = 256) -> torch.Tensor:
    """(x f32 (R, C), scale f32 (R, ceil(C/block))) -> q int8 (R, C),
    quantized against the given per-block scale."""
    name = "int8_scale_quantize"
    block = _check_block(name, block)
    _check(name, "x", x, torch.float32)
    r, c = x.shape
    _check(name, "scale", scale, torch.float32, (r, -(-c // block)))
    _same_device(name, x, scale)
    if x.device.type == "cpu":
        return ref.int8_scale_quant_ref(x, scale, block)
    q = torch.empty((r, c), dtype=torch.int8, device=x.device)
    if x.numel():
        _launch(name, "hsgd_int8_scale_quantize", x.device, x.data_ptr(),
                scale.data_ptr(), q.data_ptr(), r, c, block)
    return q
