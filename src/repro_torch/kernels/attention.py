"""The attention kernel: the wrapper over ``csrc/flash_attention.cu``.

Counterpart of the Pallas TPU kernel ``repro.kernels.flash_attention``:
:func:`flash_attention` is blocked online-softmax attention over
(B, S, H, D) tensors, causal or not, with an optional sliding window and
GQA (query head h reads key/value head h // (Hq/Hk), with no repeat in
memory).

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the output, and then either launches the CUDA kernel on
PyTorch's current stream (CUDA tensors) or runs the plain version
:func:`repro_torch.kernels.ref.attention_ref` (CPU tensors, and only
then); on ``meta`` tensors it returns the output's shape and launches
nothing.  Every call that launches adds one to :data:`launch_counts`.  It
refuses inputs that require grad while autograd records
(:func:`repro_torch.kernels.refuse_grad`): the kernel has no backward.

Each call is one kernel region for the analysis layer's recorder
(:func:`repro_torch.marks.kernel`), on either device, carrying
:func:`flash_attention_work`: what the kernel runs, priced by its design
(bfloat16: 4*D products per visible (query, key) pair per query head;
float32: the split pre-pass, then 24*D bf16-class products).

Both dtypes run on the tensor cores (``wgmma`` fed by TMA).  bfloat16 reads
q, k and v as they are.  float32 computes float32-accurate products
without TF32: a pre-pass splits q, k and v exactly into three bf16 planes
each (hi + mid + lo == x), into scratch this wrapper allocates, and every
product keeps six plane pairs (what it drops is under 2^-21 of a term).
That is 24*D tensor-core operations per visible (query, key) pair, so its
bound is 24*D at 989 TFLOP/s plus the pre-pass's 10 bytes an element; the
kernel streams plane tiles through its ring, one a stage, and releases
each as soon as the products that read it are done
(``csrc/flash_attention.cu``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import marks
from repro_torch.kernels import ref, refuse_grad

# the head dims the kernel is built for: those of the registry's configs
# and of their reduced variants
HEAD_DIMS = (32, 64, 96, 128, 192, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_YZ = 65535          # CUDA's limit on gridDim.y and gridDim.z
_INT32 = 2**31 - 1

# launches of the CUDA kernel since the last reset_launch_counts()
launch_counts: Dict[str, int] = {"flash_attention": 0}
# the float32 design: tensor-core operations per visible pair per query
# head over D (six bf16 plane products each for Q.K^T and P.V), and the
# pre-pass's bytes per element of q, k and v (read 4, write three bf16
# planes, 6)
F32_SPLIT_OPS_PER_D = 24
F32_SPLIT_BYTES = 10


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """The (query, key) pairs the mask lets through, counted row by row."""
    i = np.arange(sq)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.zeros(sq, np.int64) if window is None \
        else np.maximum(i - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_work(b: int, sq: int, sk: int, hq: int, hk: int,
                         d: int, dtype: torch.dtype, causal: bool = True,
                         window: Optional[int] = None) -> marks.Work:
    """What the kernel runs.  bfloat16: Q.K^T and P.V, 2*D products each
    per visible pair per query head (the kernel keeps float32 sums); q, k
    and v read once, o written once.  float32, in turn: the split
    pre-pass (q, k and v read in float32, written as three bf16 planes:
    ``F32_SPLIT_BYTES`` an element), then ``F32_SPLIT_OPS_PER_D``*D
    bf16-class products per visible pair per query head (six plane
    products each for Q.K^T and P.V) with the planes read and o written
    in float32."""
    pairs = visible_pairs(sq, sk, causal, window)
    n_q, n_kv = b * sq * hq * d, 2 * b * sk * hk * d
    if dtype.itemsize == 2:
        return marks.Work({"bf16": 4 * b * hq * d * pairs},
                          2 * (n_q + n_kv), 2 * n_q)
    n = n_q + n_kv
    split = marks.Work({}, 4 * n, (F32_SPLIT_BYTES - 4) * n)
    launch = marks.Work({"bf16": F32_SPLIT_OPS_PER_D * b * hq * d * pairs},
                        (F32_SPLIT_BYTES - 4) * n, 4 * n_q)
    return marks.Work.in_turn(split, launch)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int]) -> None:
    name = "flash_attention"
    for what, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {what} must be a torch.Tensor")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: {what} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name}: {what} must be 4-D (B, S, H, D), got "
                             f"shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.device.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"{name}: {what} is on {t.device}; the kernel "
                             "takes CUDA tensors, the plain version CPU "
                             "ones and the shape-only route meta ones")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name}: q, k and v must share one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"{name}: inputs on different devices "
                         f"{[str(t.device) for t in (q, k, v)]}")
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: k and v must be (B, Sk, Hk, D) with q's "
                         f"B and D; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    sk, hk = k.shape[1], k.shape[2]
    if hk == 0 or hq % hk:
        raise ValueError(f"{name}: query heads {hq} must be a multiple of "
                         f"key/value heads {hk}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} is not one of {HEAD_DIMS}")
    if window is not None and (isinstance(window, bool)
                               or not isinstance(window, int) or window < 1):
        raise ValueError(f"{name}: window must be None or an int >= 1, got "
                         f"{window!r}")
    # every query row must see a key (the kernel skips whole tiles, so a
    # row that sees none would not get the plain version's uniform mean)
    if causal and sq != sk:
        raise ValueError(f"{name}: causal attention aligns query i with key "
                         f"i and needs Sq == Sk, got {sq} and {sk}")
    if sq and sk == 0:
        raise ValueError(f"{name}: no keys for {sq} queries")
    if not causal and window is not None and sq - sk >= window:
        raise ValueError(f"{name}: with window {window}, Sq {sq} and Sk "
                         f"{sk}, the last queries see no key")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, Hq, D), k and v (B, Sk, Hk, D), all float32 or all
    bfloat16 -> (B, Sq, Hq, D) in q's dtype.  Float32 arithmetic inside."""
    causal = bool(causal)
    _check(q, k, v, causal, window)
    refuse_grad("flash_attention", q, k, v)
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    with marks.kernel("flash_attention", lambda: flash_attention_work(
            b, sq, sk, hq, hk, d, q.dtype, causal, window)):
        if q.device.type == "cpu":
            # in the kernel's (contiguous) layout, so that the caller's
            # next ops are the same on either device
            return ref.attention_ref(q, k, v, causal=causal,
                                     window=window).contiguous()
        if q.device.type == "meta":
            # shapes only, nothing launched or counted: a program recorded
            # on the meta device (the dry run) prices this region as the
            # card's does
            return torch.empty_like(q)
        return _launch(q, k, v, causal, window)


def _launch(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    if b > _GRID_YZ or hq > _GRID_YZ or max(sq, sk) > _INT32 // 2:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / "
                         f"{tuple(k.shape)} is past the kernel's grid")
    if any(t.data_ptr() % 16 for t in (q, k, v, o)):
        raise ValueError("flash_attention: q, k, v must start on 16-byte "
                         "boundaries")
    # float32: the exact bf16 planes of q, k and v, (3, B, S, H, D) each
    planes = None
    if q.dtype == torch.float32:
        planes = torch.empty(3 * (q.numel() + k.numel() + v.numel()),
                             dtype=torch.bfloat16, device=q.device)
    from repro_torch.kernels._build import load
    fn = load("flash_attention").hsgd_flash_attention
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if planes is None else planes.data_ptr(),
                 _DTYPES[q.dtype], b, sq, sk, hq, hk, d, int(causal),
                 0 if window is None else min(window, _INT32), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA kernel launch failed with "
                           f"cudaError {err}")
    launch_counts["flash_attention"] += 1
    return o
