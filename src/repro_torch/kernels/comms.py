"""The wire codecs' kernels: wrappers over ``csrc/int8_codec.cu``,
``csrc/sign_codec.cu`` and ``csrc/topk_reduce.cu``.

Counterparts of the Pallas TPU kernels in ``repro.kernels.comms``:

* :func:`int8_quantize` / :func:`int8_dequantize` — per-block symmetric
  int8 (block max-scale), one f32 scale per block;
* :func:`int8_scale_quantize` — quantize against a caller-supplied (shared
  group-max) scale, the encode side of the int8 compressed allreduce;
* :func:`sign_pack` / :func:`sign_unpack` — 1-bit signs, 8 per byte, with
  one f32 ``mean|x|`` per block;
* :func:`topk_decode_reduce` — the top-k compressed collective's receive
  side: M gathered (values, indices) payloads scatter-summed into one
  dense buffer.

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

# the largest sign block: its power-of-two padding (4 bytes an element)
# must fit the shared memory of one CTA
SIGN_MAX_BLOCK = 1 << 15

# launches of each CUDA kernel since the last reset_launch_counts()
launch_counts: Dict[str, int] = {
    "int8_quantize": 0, "int8_dequantize": 0, "int8_scale_quantize": 0,
    "sign_pack": 0, "sign_unpack": 0, "topk_decode_reduce": 0}


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


def _check_sign_block(name: str, block: int) -> int:
    block = _check_block(name, block)
    if block % 8 or block > SIGN_MAX_BLOCK:
        raise ValueError(f"{name}: block must be a multiple of 8 and at "
                         f"most {SIGN_MAX_BLOCK}, got {block}")
    return block


def _launch(name: str, source: str, entry: str, device: torch.device,
            *args) -> None:
    from repro_torch.kernels._build import load
    fn = getattr(load(source), entry)
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
        _launch(name, "int8_codec", "hsgd_int8_quantize", x.device,
                x.data_ptr(), q.data_ptr(), scale.data_ptr(), r, c, block)
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
        _launch(name, "int8_codec", "hsgd_int8_dequantize", q.device,
                q.data_ptr(), scale.data_ptr(), y.data_ptr(), r, c, block)
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
        _launch(name, "int8_codec", "hsgd_int8_scale_quantize", x.device,
                x.data_ptr(), scale.data_ptr(), q.data_ptr(), r, c, block)
    return q


def sign_pack(x: torch.Tensor, *, block: int = 1024
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x f32 (R, C) -> (bits uint8 (R, nb*block/8), scale f32 (R, nb)),
    nb = ceil(C/block); the padding of a ragged last block packs as +."""
    name = "sign_pack"
    block = _check_sign_block(name, block)
    _check(name, "x", x, torch.float32)
    if x.device.type == "cpu":
        return ref.sign_pack_ref(x, block)
    r, c = x.shape
    nb = -(-c // block)
    bits = torch.empty((r, nb * block // 8), dtype=torch.uint8,
                       device=x.device)
    scale = torch.empty((r, nb), dtype=torch.float32, device=x.device)
    if x.numel():
        _launch(name, "sign_codec", "hsgd_sign_pack", x.device,
                x.data_ptr(), bits.data_ptr(), scale.data_ptr(), r, c, block)
    return bits, scale


def sign_unpack(bits: torch.Tensor, scale: torch.Tensor, *, size: int,
                block: int = 1024) -> torch.Tensor:
    """(bits uint8 (R, nb*block/8), scale f32 (R, nb)) -> x f32 (R, size):
    ``+scale`` where the bit is set, ``-scale`` where clear."""
    name = "sign_unpack"
    block = _check_sign_block(name, block)
    size = int(size)
    if size < 0:
        raise ValueError(f"{name}: size must be >= 0, got {size}")
    nb = -(-size // block)
    _check(name, "bits", bits, torch.uint8)
    r = bits.shape[0]
    _check(name, "bits", bits, torch.uint8, (r, nb * block // 8))
    _check(name, "scale", scale, torch.float32, (r, nb))
    _same_device(name, bits, scale)
    if bits.device.type == "cpu":
        return ref.sign_unpack_ref(bits, scale, size, block)
    y = torch.empty((r, size), dtype=torch.float32, device=bits.device)
    if y.numel():
        _launch(name, "sign_codec", "hsgd_sign_unpack", bits.device,
                bits.data_ptr(), scale.data_ptr(), y.data_ptr(), r, size,
                block)
    return y


# The tiling of csrc/topk_reduce.cu (its constants, mirrored): output tiles
# of TOPK_TILE floats, chunks of TOPK_CHUNK entries that never straddle two
# members, a scan in blocks of TOPK_SCAN_BLOCK; payloads of at most
# TOPK_SMALL_ENTRIES entries into one tile take one CTA and no scratch;
# past TOPK_SMEM_BINS tiles the histogram lives in global memory.
TOPK_TILE = 1 << 14
TOPK_CHUNK = 1 << 13
TOPK_SCAN_BLOCK = 4096
TOPK_SMALL_ENTRIES = 1 << 18
TOPK_SMEM_BINS = 1 << 14
_INT32_MAX = 2**31 - 1


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def topk_plan(m: int, k: int, size: int) -> Dict[str, int]:
    """How the kernel tiles an (m, k) payload into ``size`` outputs, and the
    scratch bytes it needs: {"single": 1 if one CTA takes it all, "tiles",
    "chunks_per_member", "chunks", "scan_len", "scan_blocks",
    "shared_bins", "bytes"}."""
    entries = m * k
    tiles = -(-size // TOPK_TILE)
    plan = {"single": 0, "tiles": tiles, "chunks_per_member": 0,
            "chunks": 0, "scan_len": 0, "scan_blocks": 0, "shared_bins": 1,
            "bytes": 0}
    if size <= TOPK_TILE and entries <= TOPK_SMALL_ENTRIES:
        plan.update(single=1, tiles=int(size > 0))
        return plan
    if entries == 0 or size == 0:
        return plan
    cpm = -(-k // TOPK_CHUNK)
    chunks = m * cpm
    scan_len = tiles * chunks + 1
    scan_blocks = -(-scan_len // TOPK_SCAN_BLOCK)
    shared = tiles <= TOPK_SMEM_BINS
    nbytes = (_align16(4 * scan_len) + _align16(4 * scan_blocks)
              + (0 if shared else _align16(4 * (scan_len - 1)))
              + 8 * entries)
    plan.update(chunks_per_member=cpm, chunks=chunks, scan_len=scan_len,
                scan_blocks=scan_blocks, shared_bins=int(shared),
                bytes=nbytes)
    return plan


def topk_decode_reduce(vals: torch.Tensor, idx: torch.Tensor, *, size: int,
                       block: int = 256) -> torch.Tensor:
    """(vals f32 (M, K), idx int32 (M, K)) -> f32 (size,): the M payloads
    scatter-summed, member after member (``ref.topk_reduce_ref``).
    ``block`` is the reference's output tile; it is checked and changes no
    value (per output element the sum order does not depend on it)."""
    name = "topk_decode_reduce"
    _check_block(name, block)
    _check(name, "vals", vals, torch.float32)
    _check(name, "idx", idx, torch.int32, tuple(vals.shape))
    _same_device(name, vals, idx)
    size = int(size)
    if size < 0:
        raise ValueError(f"{name}: size must be >= 0, got {size}")
    if vals.device.type == "cpu":
        return ref.topk_reduce_ref(vals, idx, size)
    m, k = vals.shape
    if m * k > _INT32_MAX:
        raise ValueError(f"{name}: {m} x {k} entries is past the kernel's "
                         f"int32 slots")
    out = torch.empty((size,), dtype=torch.float32, device=vals.device)
    if size:
        plan = topk_plan(m, k, size)
        scratch = torch.empty((plan["bytes"],), dtype=torch.uint8,
                              device=vals.device)
        _launch(name, "topk_reduce", "hsgd_topk_decode_reduce", vals.device,
                vals.data_ptr(), idx.data_ptr(), out.data_ptr(), m, k, size,
                scratch.data_ptr() if plan["bytes"] else None, plan["bytes"])
    return out
