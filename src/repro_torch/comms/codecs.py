"""Wire codecs (``Compressor``) for sync payloads (PyTorch counterpart of
``repro.comms.codecs``).

A :class:`Compressor` defines the WIRE FORMAT of a payload buffer
independently of the aggregation rule.  Codecs see payloads as
``(rows, ...)`` tensors with a leading worker axis; trailing dims are
flattened internally.  The int8 and sign codecs run the CUDA kernels of
:mod:`repro_torch.kernels.comms` on the card (their plain versions on the
CPU).  ``topk`` is a sparsifier with error feedback: what compression drops
at one sync is carried in a per-worker residual (``HSGDState.comms``) and
re-injected at the next; its compressed collective runs the fused
decode-reduce kernel under the mesh executor.
"""
from __future__ import annotations

import abc
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import marks
from repro_torch.comms.wire import WireArray, dtype_name
from repro_torch.core.aggregators import denominator_floor
from repro_torch.device import recip_f32
from repro_torch.kernels import comms as _kernels
from repro_torch.kernels.ref import INV127


class Compressor(abc.ABC):
    """Wire codec: encode a payload to its wire arrays, decode them back.

    ``wire_reduce`` marks a codec whose :meth:`reduce` implements the
    compressed collective; ``layout_free`` marks one whose reduce does not
    depend on the payload layout (bucketization can be skipped);
    ``stateful`` marks one that carries a per-worker error-feedback
    residual.  Residual rule: :meth:`roundtrip` and :meth:`reduce` return
    the payload alone when no residual is passed, and the pair (payload,
    new residual) when one is."""

    name = "compressor"
    stateful = False
    wire_reduce = False
    layout_free = False

    @abc.abstractmethod
    def encode(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(rows, ...) payload -> the tensors that cross the wire."""

    @abc.abstractmethod
    def decode(self, wire: Dict[str, torch.Tensor],
               like: torch.Tensor) -> torch.Tensor:
        """Wire tensors -> f32 payload shaped like ``like``."""

    @abc.abstractmethod
    def wire_spec(self, length: int, dtype) -> Tuple[WireArray, ...]:
        """Static wire arrays for ONE worker's ``length``-element payload."""

    def roundtrip(self, x: torch.Tensor,
                  residual: Optional[torch.Tensor] = None):
        """What the receiver reconstructs from each worker's payload.  With
        a ``residual`` (error feedback), the residual is added before the
        encode and the pair (decoded, ``u - decoded``) comes back, ``u``
        being what was encoded; a stateless codec returns None for it."""
        if residual is None:
            return self.decode(self.encode(x), x).to(x.dtype)
        u = x.to(residual.dtype) + residual
        sent = self.decode(self.encode(u), u)
        if not self.stateful:
            return sent.to(x.dtype), None
        return sent.to(x.dtype), u - sent.to(u.dtype)

    def reduce(self, x: torch.Tensor, ops):
        """The compressed collective through ``ops`` (a WireOps): the
        group aggregate of ``x``, broadcast over the member rows.  A
        stateful codec also takes a ``residual`` (the residual rule)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no compressed-collective form")

    def lowered_sync_ops(self, backend: str) -> Optional[int]:
        """How many counted aggregation ops ONE :meth:`reduce` call runs
        per payload buffer — in-array f32/i32 reduces under ``"sim"``,
        ``MeshAxes`` collectives under ``"mesh"`` (the R1 prediction, the
        reference's numbers).  None when no exact count exists."""
        return None

    def __repr__(self):
        return f"{type(self).__name__}()"


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _div_count(v: torch.Tensor, count) -> torch.Tensor:
    """``v / count``, as the reference's jitted reduce computes it.
    Division rule: an unmasked count is a Python float, a constant that
    XLA folds into a multiply by its f32 reciprocal; a masked count is a
    tensor, and a real division."""
    if isinstance(count, float):
        return v * recip_f32(count)
    return v / count


class IdentityCompressor(Compressor):
    """No compression — the payload crosses the wire at its own dtype."""

    name = "identity"
    wire_reduce = True
    layout_free = True

    def encode(self, x):
        return {"value": x}

    def decode(self, wire, like):
        return wire["value"]

    def reduce(self, x, ops):
        return ops.mean(x)

    def lowered_sync_ops(self, backend):
        return 1

    def wire_spec(self, length, dtype):
        return (WireArray("value", (length,), dtype_name(dtype)),)


class Int8Compressor(Compressor):
    """Per-block symmetric int8 (block max-scale): 1 byte per element plus
    one f32 scale per ``block``."""

    name = "int8"
    wire_reduce = True

    def __init__(self, block: int = 256):
        self.block = int(block)

    def encode(self, x):
        q, scale = _kernels.int8_quantize(
            _rows(x).to(torch.float32).contiguous(), block=self.block)
        return {"q": q, "scale": scale}

    def decode(self, wire, like):
        y = _kernels.int8_dequantize(wire["q"], wire["scale"],
                                     block=self.block)
        return y.reshape(like.shape)

    def reduce(self, x, ops):
        """The int8 compressed allreduce: one group-max scale per block,
        quantize against it, SUM the int8 payloads in an int32 accumulator
        (exact), one decode at the end: qsum * scale / count."""
        x2 = _rows(x).to(torch.float32).contiguous()
        r, c = x2.shape
        nb = -(-c // self.block)
        pad = nb * self.block - c
        amax = F.pad(x2.abs(), (0, pad)).reshape(r, nb, self.block) \
            .amax(dim=-1)                                      # (r, nb)
        # division rule: amax / 127 as XLA runs it, amax * f32(1/127)
        scale = ops.max(amax) * INV127                         # group scale
        q = _kernels.int8_scale_quantize(x2, scale, block=self.block)
        # int32 accumulator: ops.sum keeps the operand's dtype
        qsum = ops.sum(q.to(torch.int32))
        y = (F.pad(qsum.to(torch.float32), (0, pad))
             .reshape(r, nb, self.block) * scale[..., None]) \
            .reshape(r, nb * self.block)[:, :c]
        y = _div_count(y, ops.count())
        return y.reshape(x.shape).to(x.dtype)

    def lowered_sync_ops(self, backend):
        # mesh: pmax on the scales + psum on the int32 payload; sim: the
        # block amax's group max is not a counted aggregation reduce,
        # leaving only the int32 worker-axis sum
        return 2 if backend == "mesh" else 1

    def wire_spec(self, length, dtype):
        nb = -(-length // self.block)
        return (WireArray("q", (length,), "int8"),
                WireArray("scale", (nb,), "float32"))

    def __repr__(self):
        return f"Int8Compressor(block={self.block})"


def _member_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the member axis (-2) one member after the other, the order
    XLA's reduce takes; ``torch.sum`` takes another for some group sizes
    (6, 8), and another on the card than on the CPU.  One reduce for the
    analysis layer (:func:`repro_torch.marks.reduce`), as the reference's
    one ``reduce_sum``."""
    with marks.reduce("member_sum", v):
        out = v[..., 0, :]
        for i in range(1, v.shape[-2]):
            out = out + v[..., i, :]
        return out


class SignCompressor(Compressor):
    """1-bit sign compression (1-bit SGD): 8 signs per uint8 plus a
    per-block ``mean|x|`` magnitude, ~32x fewer bytes than f32 at the
    default block.  Lossy by design: it has no error feedback, and applied
    to model parameters it replaces each by +-(block mean magnitude)."""

    name = "sign"
    wire_reduce = True

    def __init__(self, block: int = 1024):
        if int(block) % 8:
            raise ValueError(f"SignCompressor: block must be a multiple "
                             f"of 8, got {block}")
        self.block = int(block)

    def encode(self, x):
        bits, scale = _kernels.sign_pack(
            _rows(x).to(torch.float32).contiguous(), block=self.block)
        return {"bits": bits, "scale": scale}

    def decode(self, wire, like):
        y = _kernels.sign_unpack(wire["bits"], wire["scale"],
                                 size=_rows(like).shape[1], block=self.block)
        return y.reshape(like.shape)

    def reduce(self, x, ops):
        """The sign compressed reduce: the packed payload crosses the wire
        as it is (``ops.gathered``); the receiver unpacks the bits, counts
        the votes in int32 and scales by the group-mean magnitude:
        ``s_bar * (#pos - #neg) / count`` per element.  The vote is plain
        torch, as the reference computes it outside any kernel."""
        x2 = _rows(x).to(torch.float32).contiguous()
        c = x2.shape[1]
        block = self.block
        bits, scale = _kernels.sign_pack(x2, block=block)

        def fuse(bits_g, scale_g, wmask):
            # member axis at -2 (the SimWireOps.gathered contract)
            b = bits_g.to(torch.int32)
            shift = torch.arange(8, dtype=torch.int32, device=b.device)
            unpacked = (b[..., None] >> shift) & 1
            unpacked = unpacked.reshape(tuple(b.shape[:-1]) + (-1,))[..., :c]
            if wmask is None:
                votes = unpacked.sum(dim=-2, dtype=torch.int32)
                count = float(b.shape[-2])
                ssum = _member_sum(scale_g)
            else:
                votes = (unpacked * wmask.to(torch.int32)[..., None]).sum(
                    dim=-2, dtype=torch.int32)
                count = torch.maximum(
                    wmask.sum(dim=-1, keepdim=True),
                    denominator_floor(torch.float32, wmask.device))
                ssum = _member_sum(scale_g * wmask[..., None])
            sgnsum = 2.0 * votes.to(torch.float32) - count   # #pos - #neg
            sbar = _div_count(ssum, count)                   # mean scale
            per = sbar.repeat_interleave(block, dim=-1)[..., :c]
            return _div_count(per * sgnsum, count)

        out = ops.gathered(fuse, bits, scale)
        return out.reshape(x.shape).to(x.dtype)

    def lowered_sync_ops(self, backend):
        # mesh: all_gather of bits + all_gather of scales; sim: the int32
        # vote sum + the f32 scale sum over the member axis
        return 2

    def wire_spec(self, length, dtype):
        # the kernel pads the bits to whole blocks, but only ceil(length/8)
        # bytes carry information: that is what crosses the wire
        nb = -(-length // self.block)
        return (WireArray("bits", (-(-length // 8),), "uint8"),
                WireArray("scale", (nb,), "float32"))

    def __repr__(self):
        return f"SignCompressor(block={self.block})"


class TopKCompressor(Compressor):
    """Top-k magnitude sparsification with error feedback (Deep Gradient
    Compression): each sync ships the k = ``rate * length`` largest-|x|
    entries as (value, index) pairs; what is dropped stays in the
    per-worker residual and is re-injected at the next sync."""

    name = "topk"
    stateful = True
    wire_reduce = True

    def __init__(self, rate: float = 1 / 16):
        if not 0 < rate <= 1:
            raise ValueError(f"TopKCompressor: rate must be in (0, 1], "
                             f"got {rate}")
        self.rate = float(rate)

    def _k(self, length: int) -> int:
        # Python's round() rounds half to even, as the reference's does:
        # round(132.5) is 132
        return max(1, min(length, int(round(self.rate * length))))

    def encode(self, x):
        """Tie rule: ``jax.lax.top_k`` returns the entries by |x|
        descending and, among equal ones, the lower index first;
        ``torch.topk`` promises no order among ties, so the entries are
        chosen by a stable descending sort of |x|."""
        x2 = _rows(x).to(torch.float32)
        k = self._k(x2.shape[1])
        idx = torch.sort(x2.abs(), dim=1, descending=True,
                         stable=True).indices[:, :k]
        vals = torch.take_along_dim(x2, idx, dim=1)
        return {"values": vals, "indices": idx.to(torch.int32)}

    def decode(self, wire, like):
        rows = like.shape[0]
        out = torch.zeros((rows, _rows(like).shape[1]), dtype=torch.float32,
                          device=wire["values"].device)
        out.scatter_(1, wire["indices"].long(), wire["values"])
        return out.reshape(like.shape)

    def reduce(self, x, ops, residual=None):
        """The top-k compressed collective.  Error feedback and the sparse
        encode stay local and replicate :meth:`roundtrip`'s casts, so the
        residuals are the legacy path's bit for bit; the (values, indices)
        payload then goes to ``ops.sparse_mean``: the dense group mean on
        sim, an all-gather and the fused decode-reduce kernel on the
        mesh."""
        u = x if residual is None else x.to(residual.dtype) + residual
        wire = self.encode(u)
        sent = self.decode(wire, u)
        out = ops.sparse_mean(wire["values"], wire["indices"],
                              sent.to(x.dtype))
        out = out.to(x.dtype).reshape(x.shape)
        if residual is None:
            return out
        return out, u - sent.to(u.dtype)

    def lowered_sync_ops(self, backend):
        # mesh: all_gather of values + all_gather of indices (the fused
        # decode-reduce is the kernel's); sim: one dense f32 group mean
        return 2 if backend == "mesh" else 1

    def wire_spec(self, length, dtype):
        k = self._k(length)
        return (WireArray("values", (k,), "float32"),
                WireArray("indices", (k,), "int32"))

    def __repr__(self):
        return f"TopKCompressor(rate={self.rate:g})"


COMPRESSORS = {
    "identity": IdentityCompressor,
    "none": IdentityCompressor,
    "int8": Int8Compressor,
    "q8": Int8Compressor,
    "sign": SignCompressor,
    "1bit": SignCompressor,
    "topk": TopKCompressor,
}

CompressorLike = Union[str, Compressor, None]


def make_compressor(spec: CompressorLike = None, **kwargs) -> Compressor:
    """Resolve a compressor from an instance, a registry name, or None
    (-> IdentityCompressor).  ``kwargs`` construct it by name, e.g.
    ``make_compressor("sign", block=256)``."""
    if isinstance(spec, Compressor):
        if kwargs:
            raise ValueError(
                f"kwargs {sorted(kwargs)} only apply when constructing by "
                f"name; got the instance {spec!r}")
        return spec
    if spec is None:
        return IdentityCompressor(**kwargs)
    name = spec.lower()
    if name not in COMPRESSORS:
        raise KeyError(f"unknown compressor {spec!r}; "
                       f"known: {sorted(COMPRESSORS)}")
    return COMPRESSORS[name](**kwargs)
