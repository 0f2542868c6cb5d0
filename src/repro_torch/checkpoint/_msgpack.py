"""The msgpack subset the checkpoint files use, in plain Python.

``packb`` writes nil, bool, int (smallest format), float (float64), str,
bin, array and map exactly as ``msgpack.packb(obj, use_bin_type=True)``
does, so a file the port writes is byte for byte the one the reference
writes for the same tree. ``unpackb`` reads every non-extension format
(float32 and the str/bin/array/map widths included) as
``msgpack.unpackb(raw=False)`` does, except that bin payloads come back
as ``memoryview`` slices of the input: a checkpoint's arrays are read
without copying them out of the file's buffer.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, List, Tuple

_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def _int_header(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -0x20 <= n < 0:
        return bytes((n & 0xff,))
    if n >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < top:
                return bytes((code,)) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)), (0xd3, ">q", -(1 << 63))):
            if n >= low:
                return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix: Tuple[int, int], wide: Tuple[int, ...]) -> bytes:
    """A length header: the fix format below ``fix[1]``, else the first
    of (8-bit, 16-bit, 32-bit) codes in ``wide`` (0 = absent) it fits."""
    if fix[1] and n < fix[1]:
        return bytes((fix[0] | n,))
    for code, fmt, top in zip(wide, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code and n < top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} is too large")


def _pack(obj: Any, out: List) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int_header(int(obj)))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_sized(len(data), (0xa0, 32), (0xd9, 0xda, 0xdb)))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        size = memoryview(obj).nbytes
        out.append(_sized(size, (0, 0), (0xc4, 0xc5, 0xc6)))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        out.append(_sized(len(obj), (0x90, 16), (0, 0xdc, 0xdd)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), (0x80, 16), (0, 0xde, 0xdf)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def pack_chunks(obj: Any) -> List:
    """``obj``'s msgpack encoding as a list of byte chunks (a bin's
    payload is its own chunk, not copied)."""
    out: List = []
    _pack(obj, out)
    return out


def packb(obj: Any) -> bytes:
    return b"".join(pack_chunks(obj))


class _Reader:
    def __init__(self, buf):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def fixed(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b & 0xf0 == 0x80:
            return self.mapping(b & 0x0f)
        if b & 0xf0 == 0x90:
            return [self.value() for _ in range(b & 0x0f)]
        if b & 0xe0 == 0xa0:
            return str(self.take(b & 0x1f), "utf-8")
        if b in _FIXED:
            return self.fixed(_FIXED[b])
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized: dict = {
            0xc4: (">B", self.take), 0xc5: (">H", self.take),
            0xc6: (">I", self.take),
            0xd9: (">B", self.text), 0xda: (">H", self.text),
            0xdb: (">I", self.text),
            0xdc: (">H", self.array), 0xdd: (">I", self.array),
            0xde: (">H", self.mapping), 0xdf: (">I", self.mapping)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.fixed(fmt))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(buf) -> Any:
    """Decode one msgpack object filling ``buf`` (any buffer)."""
    r = _Reader(buf)
    obj = r.value()
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} bytes of extra data after "
                         f"the msgpack object")
    return obj
