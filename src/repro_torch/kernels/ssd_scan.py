"""The SSD scan kernel: the wrapper over ``csrc/ssd_scan.cu``.

Counterpart of the Pallas TPU kernel ``repro.kernels.ssd_scan``:
:func:`ssd_scan` is Mamba-2's chunked state-space scan, y_t = C_t . h_t
with h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t from a zero state.

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the output and the kernel's scratch (:func:`ssd_plan`),
and then either launches the CUDA kernel on PyTorch's current stream
(CUDA tensors) or runs the plain version
:func:`repro_torch.kernels.ref.ssd_ref` (CPU tensors, and only then).
The kernel is chunk-parallel: one call is four launches (prep,
chunk_state, state_pass, chunk_scan; ``csrc/ssd_scan.cu``), and adds one
to :data:`launch_counts`.  It refuses inputs that require grad while
autograd records (:func:`repro_torch.kernels.refuse_grad`).

Each call is one kernel region for the analysis layer's recorder
(:func:`repro_torch.marks.kernel`), on either device, carrying
:func:`ssd_scan_work`.

Strided inputs: the kernel takes the batch and sequence strides of x, B
and C and reads them in place when their inner dims are packed (x's
(H, P), B's and C's N), as for the column slices of one projection that
``models.layers.ssd_apply`` passes; any other layout is copied to a
contiguous tensor first (:func:`kernel_operands`).  dt and A are made
contiguous.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch import marks
from repro_torch.kernels import ref, refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' register tiles: chunk <= 64 rows, head dim <= 64 columns,
# state <= 256 columns; and the card's shared memory for one CTA
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 256
MAX_SMEM = 232448
N_TILE = 64               # columns of N the kernels stage at a time
_GRID_YZ = 65535          # CUDA's limit on gridDim.y and gridDim.z

# calls that launched the CUDA kernel since the last reset_launch_counts()
launch_counts: Dict[str, int] = {"ssd_scan": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def smem_bytes(chunk: int, p: int, n: int) -> int:
    """Dynamic shared memory of the largest CTA of the launches of either
    route.  float32: chunk_state stages x (Q, P), B (Q, N) and w (Q);
    chunk_scan x (Q, P), a tile of C (Q, N_TILE + 1) and of the state (P,
    N_TILE + 1), M (Q, Q + 1), cum and dt (Q each).  bfloat16, padded to
    multiples of 16 with rows of (width + 8) bf16: prep stages C and B
    (Q, N); chunk_state x (Q, P), three terms of w B (Q, N_TILE) and w;
    chunk_scan x, three terms of M (Q, Q), a tile of C (Q, N_TILE), three
    of the state (P, N_TILE), cum and dt."""
    f32_state = 4 * (chunk * p + chunk * n + chunk)
    f32_scan = 4 * (chunk * p + (chunk + p) * (N_TILE + 1)
                    + chunk * (chunk + 1) + 2 * chunk)
    q, pp, tb = _r16(chunk), _r16(p), N_TILE + 8
    bf16_prep = 2 * 2 * q * (_r16(n) + 8)
    bf16_state = 2 * (q * (pp + 8) + 3 * q * tb) + 4 * q
    bf16_scan = (2 * (q * (pp + 8) + 3 * q * (q + 8) + q * tb + 3 * pp * tb)
                 + 8 * q)
    return max(f32_state, f32_scan, bf16_prep, bf16_state, bf16_scan)


def ssd_plan(bt: int, s: int, h: int, p: int, n: int, chunk: int
             ) -> Dict[str, object]:
    """The kernel's float32 scratch for x (bt, s, h, p) and B, C (bt, s, n)
    in chunks of ``chunk``, the mirror of ``csrc/ssd_scan.cu``'s buffers:
    {"chunks": nc = ceil(s / chunk), "states": (bt, nc, h, p, n) (each
    chunk's own state, then the state entering it), "G": (bt, nc, chunk,
    chunk) (C B^T, shared by the heads), "cum": (bt, nc, h, chunk), and
    their sizes in bytes, "states_bytes", "G_bytes", "cum_bytes",
    "bytes"}."""
    nc = -(-s // chunk)
    shapes = {"states": (bt, nc, h, p, n), "G": (bt, nc, chunk, chunk),
              "cum": (bt, nc, h, chunk)}
    plan: Dict[str, object] = {"chunks": nc, **shapes}
    for k, shape in shapes.items():
        plan[f"{k}_bytes"] = 4 * math.prod(shape)
    plan["bytes"] = sum(plan[f"{k}_bytes"] for k in shapes)
    return plan


def ssd_ops(bt: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """Operations of the chunked scan on these shapes: per chunk of L
    positions, C B^T on the causal triangle (shared by the heads), and per
    head the triangle's product with x, C times the state and the state
    update."""
    ops = 0
    for s0 in range(0, s, chunk):
        ln = min(chunk, s - s0)
        tri = ln * (ln + 1) // 2
        ops += 2 * tri * n + h * (2 * tri * p + 4 * ln * p * n)
    return bt * ops


def ssd_scan_work(bt: int, s: int, h: int, p: int, n: int, chunk: int,
                  dtype: torch.dtype) -> marks.Work:
    """The function's work: :func:`ssd_ops` as products in x's dtype
    (16-bit or float32); x, B and C in x's dtype and dt and A in float32
    read, y in x's dtype written."""
    e = dtype.itemsize
    return marks.Work({"bf16" if e == 2 else "f32":
                       ssd_ops(bt, s, h, p, n, chunk)},
                      e * bt * s * (h * p + 2 * n) + 4 * (bt * s * h + h),
                      e * bt * s * h * p)


def ssd_design_bytes(bt: int, s: int, h: int, p: int, n: int,
                     chunk: int) -> int:
    """The scratch traffic the kernel's passes add to the function's bytes
    (:func:`ssd_plan`): the chunk states written (chunk_state), read and
    written (state_pass) and read (chunk_scan); G written and read; cum
    written and read twice."""
    plan = ssd_plan(bt, s, h, p, n, chunk)
    return (4 * plan["states_bytes"] + 2 * plan["G_bytes"]
            + 3 * plan["cum_bytes"])


def _check(x, dt, A, B, C, chunk) -> None:
    name = "ssd_scan"
    for what, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {what} must be a torch.Tensor")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: {what} is on {t.device}; the kernel "
                             "takes CUDA tensors and the plain version CPU "
                             "ones")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.dtype == B.dtype == C.dtype:
        raise TypeError(f"{name}: x, B and C must share one dtype, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{name}: dt and A must be float32, got {dt.dtype} "
                        f"and {A.dtype}")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError(f"{name}: inputs on different devices "
                         f"{[str(t.device) for t in (x, dt, A, B, C)]}")
    if x.ndim != 4:
        raise ValueError(f"{name}: x must be 4-D (Bt, S, H, P), got shape "
                         f"{tuple(x.shape)}")
    bt, s, h, p = x.shape
    n = B.shape[-1] if B.ndim == 3 else -1
    if (dt.shape != (bt, s, h) or A.shape != (h,) or B.shape != (bt, s, n)
            or C.shape != B.shape):
        raise ValueError(f"{name}: want dt (Bt, S, H), A (H,), B and C "
                         f"(Bt, S, N) for x {tuple(x.shape)}; got dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"{name}: chunk must be an int >= 1, got {chunk!r}")


def kernel_operands(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[int, ...]]:
    """(x, B, C) as the kernel reads them, and their (batch, sequence)
    strides in elements: each tensor itself where its inner dims are packed
    (x's (H, P), B's and C's N), else a contiguous copy."""
    p = x.shape[3]
    if not (x.stride(3) == 1 and x.stride(2) == p):
        x = x.contiguous()
    out, strides = [x], [x.stride(0), x.stride(1)]
    for t in (B, C):
        if t.stride(2) != 1:
            t = t.contiguous()
        out.append(t)
        strides += [t.stride(0), t.stride(1)]
    return tuple(out), tuple(strides)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 64) -> torch.Tensor:
    """x (Bt, S, H, P); dt (Bt, S, H) float32 >= 0; A (H,) float32 < 0;
    B, C (Bt, S, N) in x's dtype (float32 or bfloat16) -> y (Bt, S, H, P)
    in x's dtype.  Float32 arithmetic inside, in chunks of ``chunk``
    positions; a ragged last chunk is masked (the result equals that of
    inputs zero-padded to a multiple of ``chunk``, cut back to S)."""
    _check(x, dt, A, B, C, chunk)
    refuse_grad("ssd_scan", x, dt, A, B, C)
    with marks.kernel("ssd_scan", lambda: ssd_scan_work(
            *x.shape, B.shape[-1], chunk, x.dtype)):
        if x.device.type == "cpu":
            return ref.ssd_ref(x, dt, A, B, C)[0]
        return _launch(x, dt, A, B, C, chunk)


def _launch(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    bt, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty((bt, s, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if chunk > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan: the kernel takes chunk <= {MAX_CHUNK}, "
                         f"head dim <= {MAX_HEAD_DIM} and state <= "
                         f"{MAX_STATE}; got {chunk}, {p}, {n}")
    if smem_bytes(chunk, p, n) > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk {chunk}, head dim {p}, state {n} "
                         f"need {smem_bytes(chunk, p, n)} bytes of shared "
                         f"memory, more than {MAX_SMEM}")
    plan = ssd_plan(bt, s, h, p, n, chunk)
    if max(bt, h, plan["chunks"]) > _GRID_YZ:
        raise ValueError(f"ssd_scan: shape {tuple(x.shape)} in chunks of "
                         f"{chunk} is past the kernel's grid")
    (x, B, C), strides = kernel_operands(x, B, C)
    dt, A = dt.contiguous(), A.contiguous()
    scratch = [torch.empty(plan[k], dtype=torch.float32, device=x.device)
               for k in ("states", "G", "cum")]
    from repro_torch.kernels._build import load
    fn = load("ssd_scan").hsgd_ssd_scan
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(),
                 *(t.data_ptr() for t in scratch), _DTYPES[x.dtype], bt, s,
                 h, p, n, chunk, *strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: CUDA kernel launch failed with "
                           f"cudaError {err}")
    launch_counts["ssd_scan"] += 1
    return y
