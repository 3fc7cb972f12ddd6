"""The subset of MessagePack that checkpoints use, written and read as a
stream (the port's own codec: the card's machine has no ``msgpack``).

Encodings are msgpack's smallest, as ``msgpack.packb(obj,
use_bin_type=True)`` picks them: fix/16/32 maps and arrays, fix/8/16/32
strings, positive and negative ints in the fewest bytes and bin8/16/32,
which is every type a checkpoint holds.  Dict entries go out in insertion
order, so a file is byte for byte the one ``msgpack`` writes for the same
object.

:class:`Blob` is a bin whose bytes are produced chunk by chunk while it is
written, so a multi-GB checkpoint never exists as one ``bytes`` object.
Reading returns each bin as a ``bytearray`` filled by ``readinto`` (a
writable buffer that ``torch.frombuffer`` takes without a copy).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, BinaryIO, Callable, Iterable


@dataclasses.dataclass(frozen=True)
class Blob:
    """A bin of ``nbytes`` bytes, written as the buffers ``chunks()``
    yields (their lengths must add up to ``nbytes``)."""
    nbytes: int
    chunks: Callable[[], Iterable[Any]]


def _head(fix: int, fix_max: int, c16: int, c32: int, n: int,
          c8: int = 0) -> bytes:
    if n <= fix_max:
        return bytes([fix | n])
    if c8 and n <= 0xFF:
        return struct.pack(">BB", c8, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", c16, n)
    return struct.pack(">BI", c32, n)


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v > 0:
        for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                               (0xCE, ">BI", 0xFFFFFFFF)):
            if v <= top:
                return struct.pack(fmt, code, v)
        return struct.pack(">BQ", 0xCF, v)
    for code, fmt, low in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                           (0xD2, ">Bi", -0x80000000)):
        if v >= low:
            return struct.pack(fmt, code, v)
    return struct.pack(">Bq", 0xD3, v)


def _bin_head(n: int) -> bytes:
    if n <= 0xFF:
        return struct.pack(">BB", 0xC4, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", 0xC5, n)
    return struct.pack(">BI", 0xC6, n)


def write(f: BinaryIO, obj) -> None:
    """Write ``obj`` (dict, list, tuple, str, int, bytes or
    :class:`Blob`) to the binary stream ``f``."""
    if isinstance(obj, int) and not isinstance(obj, bool):
        f.write(_int(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        f.write(_head(0xA0, 31, 0xDA, 0xDB, len(raw), c8=0xD9))
        f.write(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        f.write(_bin_head(raw.nbytes))
        f.write(raw)
    elif isinstance(obj, Blob):
        f.write(_bin_head(obj.nbytes))
        n = 0
        for chunk in obj.chunks():
            n += f.write(chunk)
        if n != obj.nbytes:
            raise ValueError(f"Blob declared {obj.nbytes} bytes, wrote {n}")
    elif isinstance(obj, dict):
        f.write(_head(0x80, 15, 0xDE, 0xDF, len(obj)))
        for k, v in obj.items():
            write(f, k)
            write(f, v)
    elif isinstance(obj, (list, tuple)):
        f.write(_head(0x90, 15, 0xDC, 0xDD, len(obj)))
        for v in obj:
            write(f, v)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _exact(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError("truncated msgpack stream")
    return b


def _unpack(f: BinaryIO, fmt: str) -> Any:
    return struct.unpack(fmt, _exact(f, struct.calcsize(fmt)))[0]


def _read_bin(f: BinaryIO, n: int) -> bytearray:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = f.readinto(view[got:])
        if not k:
            raise EOFError("truncated msgpack stream")
        got += k
    return buf


def read_header(f: BinaryIO, kind: str) -> int:
    """The entry count of the map (``kind="map"``) or array
    (``kind="array"``) that starts at the stream's position."""
    c = _exact(f, 1)[0]
    fix, c16, c32 = (0x80, 0xDE, 0xDF) if kind == "map" \
        else (0x90, 0xDC, 0xDD)
    if c & 0xF0 == fix:
        return c & 0x0F
    if c == c16:
        return _unpack(f, ">H")
    if c == c32:
        return _unpack(f, ">I")
    raise ValueError(f"expected a msgpack {kind}, got byte 0x{c:02x}")


_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
         0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",     # str 8/16/32
        0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}     # bin 8/16/32


def read(f: BinaryIO):
    """The next object of the stream (maps as dicts, arrays as lists, bins
    as bytearrays)."""
    c = _exact(f, 1)[0]
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F or c in (0xDE, 0xDF):
        n = c & 0x0F if c <= 0x8F else _unpack(f, ">H" if c == 0xDE else ">I")
        out = {}
        for _ in range(n):
            k = read(f)
            out[k] = read(f)
        return out
    if 0x90 <= c <= 0x9F or c in (0xDC, 0xDD):
        n = c & 0x0F if c <= 0x9F else _unpack(f, ">H" if c == 0xDC else ">I")
        return [read(f) for _ in range(n)]
    if 0xA0 <= c <= 0xBF:
        return _exact(f, c & 0x1F).decode("utf-8")
    if c in _LEN:
        n = _unpack(f, _LEN[c])
        return _exact(f, n).decode("utf-8") if c >= 0xD9 \
            else _read_bin(f, n)
    if c in _INTS:
        return _unpack(f, _INTS[c])
    raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")
