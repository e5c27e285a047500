"""A msgpack codec for the subset of types that checkpoint files hold.

The machine with the card has no msgpack package, so the port carries its
own codec.  `packb` writes nil, bool, int (every width, signed and
unsigned), float (as float64), str, bytes-like (bin), list and tuple
(array) and dict (map) with the same bytes as ``msgpack.packb(obj,
use_bin_type=True)``; `unpackb` reads everything msgpack writes for those
types, float32 and every fixed, 8-, 16- and 32-bit length form included,
as ``msgpack.unpackb(data, raw=False)`` does (arrays come back as lists).
Anything else raises: `TypeError` on packing, `ValueError` on unpacking a
truncated, trailing or unknown byte sequence.
"""
from __future__ import annotations

import struct

_B, _H, _I, _Q = (struct.Struct(">" + c) for c in "BHIQ")
_b, _h, _i, _q = (struct.Struct(">" + c) for c in "bhiq")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_FIXED = {0xCA: _F32, 0xCB: _F64, 0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
          0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
_SIZED = {0xC4: (_B, "bin"), 0xC5: (_H, "bin"), 0xC6: (_I, "bin"),
          0xD9: (_B, "str"), 0xDA: (_H, "str"), 0xDB: (_I, "str"),
          0xDC: (_H, "array"), 0xDD: (_I, "array"), 0xDE: (_H, "map"),
          0xDF: (_I, "map")}


def _length(out: list, n: int, fix: int | None, fix_max: int,
            codes: tuple) -> None:
    """The header of a str / bin / array / map of length ``n``: a fixed
    form (``fix | n``) when ``n`` is below ``fix_max``, else the 8- (str and
    bin only), 16- or 32-bit form."""
    c8, c16, c32 = codes
    if fix is not None and n < fix_max:
        out.append(_B.pack(fix | n))
    elif c8 is not None and n <= 0xFF:
        out.append(_B.pack(c8) + _B.pack(n))
    elif n <= 0xFFFF:
        out.append(_B.pack(c16) + _H.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(_B.pack(c32) + _I.pack(n))
    else:
        raise ValueError(f"msgpack length {n} exceeds 2^32 - 1")


def _int(out: list, x: int) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(_B.pack(x))
        elif x <= 0xFF:
            out.append(b"\xcc" + _B.pack(x))
        elif x <= 0xFFFF:
            out.append(b"\xcd" + _H.pack(x))
        elif x <= 0xFFFFFFFF:
            out.append(b"\xce" + _I.pack(x))
        elif x <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _Q.pack(x))
        else:
            raise OverflowError(f"int {x} does not fit msgpack's uint64")
    elif x >= -32:
        out.append(_b.pack(x))
    elif x >= -0x80:
        out.append(b"\xd0" + _b.pack(x))
    elif x >= -0x8000:
        out.append(b"\xd1" + _h.pack(x))
    elif x >= -0x80000000:
        out.append(b"\xd2" + _i.pack(x))
    elif x >= -0x8000000000000000:
        out.append(b"\xd3" + _q.pack(x))
    else:
        raise OverflowError(f"int {x} does not fit msgpack's int64")


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(out, int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        _length(out, data.nbytes, None, 0, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _length(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, dict):
        _length(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _length(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def pack_chunks(obj) -> list:
    """`packb`'s bytes as a list of pieces (bin payloads by reference, not
    copied), for ``file.writelines``."""
    out: list = []
    _pack(out, obj)
    return out


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes, equal to ``msgpack.packb(obj,
    use_bin_type=True)``."""
    return b"".join(pack_chunks(obj))


class _Reader:
    def __init__(self, data, bin_views: bool):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.bin_views = bin_views

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data is truncated")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def obj(self):
        c = self.unpack(_B)
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if c < 0x90:
            return self.map(c & 0x0F)
        if c < 0xA0:
            return self.array(c & 0x0F)
        if c < 0xC0:
            return self.str(c & 0x1F)
        if c in _SIMPLE:
            return _SIMPLE[c]
        if c in _FIXED:
            return self.unpack(_FIXED[c])
        if c in _SIZED:
            st, kind = _SIZED[c]
            return getattr(self, kind)(self.unpack(st))
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def bin(self, n: int):
        view = self.take(n)
        return view if self.bin_views else bytes(view)

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data, *, bin_views: bool = False):
    """The object that msgpack ``data`` holds, as ``msgpack.unpackb(data,
    raw=False)`` returns it; `ValueError` on truncated or trailing bytes.
    ``bin_views`` returns each bin as a memoryview into ``data`` in place of
    a copy (writable when ``data`` is a bytearray)."""
    r = _Reader(data, bin_views)
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack data has {len(r.buf) - r.pos} trailing "
                         f"bytes")
    return obj
