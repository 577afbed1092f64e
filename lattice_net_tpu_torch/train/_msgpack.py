"""The subset of MessagePack that flax checkpoints use, with numpy arrays in
flax's extension types, written with the standard library and numpy.

flax (``flax/serialization.py``) packs a state dict with ``msgpack``: maps,
arrays, str, bin, int, float, bool and nil, and three extension types:

* code 1, an ndarray: the payload is itself packed, ``[shape, dtype name,
  C-order bytes]`` (an array of ints, a str, a bin);
* code 2, a native complex: the payload is a packed ``[real, imag]``;
* code 3, a numpy scalar: an ndarray payload of shape ``()``.

:func:`packb` writes dicts (str keys), lists and tuples, str, bytes, bool,
None, int, float, complex, numpy arrays (ext 1) and numpy scalars (ext 3).
:func:`unpackb` reads every MessagePack type and those three extensions;
ext 1 comes back as a writable numpy array, ext 3 as a numpy scalar.
Arrays flax splits into chunks (leaves over 1 GiB) are not read.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif 0 <= x < 1 << 64:
        for code, fmt, top in ((0xCC, ">B", 8), (0xCD, ">H", 16), (0xCE, ">I", 32), (0xCF, ">Q", 64)):
            if x < 1 << top:
                out += bytes([code]) + struct.pack(fmt, x)
                return
    elif -(1 << 63) <= x < 0:
        for code, fmt, top in ((0xD0, ">b", 7), (0xD1, ">h", 15), (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if x >= -(1 << top):
                out += bytes([code]) + struct.pack(fmt, x)
                return
    else:
        raise OverflowError(f"int {x} does not fit 64 bits")


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int, codes) -> None:
    """A length header: the fix form (``fix | n``) for ``n < fix_max``, else
    the 8/16/32-bit form from ``codes`` (a None code: no such width)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (8, 16, 32)):
        if code is not None and n < 1 << top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit 32 bits")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise ValueError(f"dtype {arr.dtype} cannot be serialised")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):  # before int, its base class
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, complex):
        _pack_ext(out, EXT_COMPLEX, packb([x.real, x.imag]))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for item in x:
            _pack(out, item)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes, numpy arrays and scalars as flax's
    extension types (dict keys in insertion order)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}  # fmt: skip
# the types with a length after the type byte: (kind, length format)
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"), 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}  # fmt: skip


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos : self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0F)
        if b < 0xA0:
            return self.array(b & 0x0F)
        if b < 0xC0:
            return self.str(b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            return getattr(self, kind)(self.unpack(fmt))
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"unknown MessagePack type byte 0x{b:02x}")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

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

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        if code == EXT_COMPLEX:
            real, imag = unpackb(data)
            return complex(real, imag)
        raise ValueError(f"unknown MessagePack extension type {code}")


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype, buf = unpackb(data)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        raise ValueError("bfloat16 arrays are not read: numpy has no bfloat16")
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpackb(data: bytes):
    """The object MessagePack ``data`` holds (maps as dicts, arrays as
    lists, flax's extension types as numpy arrays, scalars and complex)."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the MessagePack object")
    return out
