"""Wire codecs (``Compressor``) for sync payloads (PyTorch counterpart of
``repro.comms.codecs``).

A :class:`Compressor` defines the WIRE FORMAT of a payload buffer
independently of the aggregation rule.  Codecs see payloads as
``(rows, ...)`` tensors with a leading worker axis; trailing dims are
flattened internally.  The int8 and sign codecs run the CUDA kernels of
:mod:`repro_torch.kernels.comms` on the card (their plain versions on the
CPU).  The registry holds identity, int8 and sign; top-k comes with ROADMAP
B6.
"""
from __future__ import annotations

import abc
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.comms.wire import WireArray, dtype_name
from repro_torch.core.aggregators import denominator_floor
from repro_torch.device import recip_f32
from repro_torch.kernels import comms as _kernels
from repro_torch.kernels.ref import INV127


class Compressor(abc.ABC):
    """Wire codec: encode a payload to its wire arrays, decode them back.

    ``wire_reduce`` marks a codec whose :meth:`reduce` implements the
    compressed collective; ``layout_free`` marks one whose reduce does not
    depend on the payload layout (bucketization can be skipped).  No
    ported codec carries an error-feedback residual: that comes with top-k
    (ROADMAP B6)."""

    name = "compressor"
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

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """What the receiver reconstructs from each worker's payload."""
        return self.decode(self.encode(x), x).to(x.dtype)

    def reduce(self, x: torch.Tensor, ops) -> torch.Tensor:
        """The compressed collective through ``ops`` (a WireOps): the
        group aggregate of ``x``, broadcast over the member rows."""
        raise NotImplementedError(
            f"{type(self).__name__} has no compressed-collective form")

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

    def wire_spec(self, length, dtype):
        nb = -(-length // self.block)
        return (WireArray("q", (length,), "int8"),
                WireArray("scale", (nb,), "float32"))

    def __repr__(self):
        return f"Int8Compressor(block={self.block})"


def _member_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the member axis (-2) one member after the other, the order
    XLA's reduce takes; ``torch.sum`` takes another for some group sizes
    (6, 8), and another on the card than on the CPU."""
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

    def wire_spec(self, length, dtype):
        # the kernel pads the bits to whole blocks, but only ceil(length/8)
        # bytes carry information: that is what crosses the wire
        nb = -(-length // self.block)
        return (WireArray("bits", (-(-length // 8),), "uint8"),
                WireArray("scale", (nb,), "float32"))

    def __repr__(self):
        return f"SignCompressor(block={self.block})"


COMPRESSORS = {
    "identity": IdentityCompressor,
    "none": IdentityCompressor,
    "int8": Int8Compressor,
    "q8": Int8Compressor,
    "sign": SignCompressor,
    "1bit": SignCompressor,
}
# registered in the JAX package, not ported yet: name -> ROADMAP item
_NOT_PORTED = {"topk": "B6"}

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
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"compressor {spec!r} is not ported yet (ROADMAP "
            f"{_NOT_PORTED[name]}); the port has {sorted(COMPRESSORS)}")
    if name not in COMPRESSORS:
        raise KeyError(f"unknown compressor {spec!r}; "
                       f"known: {sorted(COMPRESSORS)}")
    return COMPRESSORS[name](**kwargs)
