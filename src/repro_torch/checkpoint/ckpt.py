"""Pytree checkpointing: a msgpack container of raw buffers, the format of
``repro.checkpoint.ckpt`` byte for byte (PyTorch counterpart).

One file per step, ``ckpt_{step:08d}.msgpack``, written atomically (a temp
file in the same directory, then ``os.replace``).  It holds one map
``{"step", "payload"}``; ``payload`` lists the tree's leaves in
:mod:`repro_torch.tree` order (``jax.tree.leaves``'s), each a map
``{"dtype", "wire", "shape", "data"}``.  bfloat16 leaves travel as their
uint16 bit patterns (``"wire": "uint16"``).  Leaves are written one after
another in chunks of at most ``CHUNK_BYTES`` (a full-width checkpoint is
GBs) and read back one at a time onto the device the caller names.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Optional

import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.comms.wire import dtype_name
from repro_torch.device import DeviceLike
from repro_torch.tree import tree_flatten

CHUNK_BYTES = 1 << 26


def _chunks(t: torch.Tensor):
    """The tensor's bytes in chunks of at most CHUNK_BYTES, each copied to
    the host as it is written."""
    flat = t.detach().reshape(-1)
    if flat.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    per = max(1, CHUNK_BYTES // max(flat.element_size(), 1))

    def gen():
        for i in range(0, flat.numel(), per):
            a = flat[i:i + per].cpu().contiguous().numpy()
            yield memoryview(a).cast("B")
    return gen


def _entry(leaf: torch.Tensor) -> dict:
    name = dtype_name(leaf.dtype)
    return {"dtype": name,
            "wire": "uint16" if leaf.dtype == torch.bfloat16 else name,
            "shape": [int(d) for d in leaf.shape],
            "data": _msgpack.Blob(leaf.numel() * leaf.element_size(),
                                  _chunks(leaf))}


def save(path: str, step: int, tree: Any) -> str:
    """Write ``tree``'s leaves (tensors on any device) as step ``step``
    under ``path``; returns the file's path."""
    os.makedirs(path, exist_ok=True)
    leaves, _ = tree_flatten(tree)
    fname = os.path.join(path, f"ckpt_{step:08d}.msgpack")
    fd, tmp = tempfile.mkstemp(dir=path)
    try:
        with os.fdopen(fd, "wb") as f:
            _msgpack.write(f, {"step": step,
                               "payload": [_entry(l) for l in leaves]})
        os.replace(tmp, fname)
    except BaseException:
        os.unlink(tmp)
        raise
    return fname


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:13]) for f in os.listdir(path)
             if f.startswith("ckpt_") and f.endswith(".msgpack")]
    return max(steps) if steps else None


def _leaf(rec: dict, tmpl: torch.Tensor,
          device: Optional[DeviceLike]) -> torch.Tensor:
    shape = tuple(rec["shape"])
    assert shape == tuple(tmpl.shape), (shape, tuple(tmpl.shape))
    bf16 = rec["dtype"] == "bfloat16"
    wire = torch.int16 if bf16 else getattr(torch, rec["wire"])
    data = rec["data"]
    t = torch.frombuffer(data, dtype=wire) if len(data) \
        else torch.empty(0, dtype=wire)
    t = t.reshape(shape)
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device=tmpl.device if device is None else device,
                dtype=tmpl.dtype)


def restore(path: str, template: Any, step: Optional[int] = None, *,
            device: Optional[DeviceLike] = None):
    """Returns ``(step, tree shaped like template)``: tensors of the
    template's dtypes on ``device`` (default: each template leaf's own).
    Raises ``AssertionError`` when ``path`` holds no checkpoint, or on a
    structure or shape mismatch with ``template``."""
    if step is None:
        step = latest_step(path)
        assert step is not None, f"no checkpoints under {path}"
    leaves, treedef = tree_flatten(template)
    out, saved_step = [], None
    with open(os.path.join(path, f"ckpt_{step:08d}.msgpack"), "rb") as f:
        for _ in range(_msgpack.read_header(f, "map")):
            key = _msgpack.read(f)
            if key != "payload":
                val = _msgpack.read(f)
                if key == "step":
                    saved_step = val
                continue
            n = _msgpack.read_header(f, "array")
            assert n == len(leaves), "checkpoint/template structure mismatch"
            # one leaf's host buffer at a time
            out = [_leaf(_msgpack.read(f), tmpl, device) for tmpl in leaves]
    assert len(out) == len(leaves), "checkpoint/template structure mismatch"
    return saved_step, treedef.unflatten(out)
