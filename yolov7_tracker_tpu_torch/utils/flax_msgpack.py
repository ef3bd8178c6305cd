"""A reader and a writer of the msgpack files that Flax writes
(``flax.serialization.to_bytes``), in Python and numpy alone: the port
imports neither flax nor the ``msgpack`` package, and the GPU machine need
not have either.

The reader decodes the subset those files use: maps, arrays, strings,
bin, ints, floats, nil and booleans, and Flax's ext type 1, an ndarray
whose payload is itself msgpack of ``(shape, dtype name, raw buffer)``.
Any other ext code (Flax's complex numbers and numpy scalars, say)
raises. The writer (``dumps``, ``save_variables``) encodes a tree of
dicts with str keys and ndarray leaves as Flax does, byte for byte: maps
in the tree's key order, each array as ext 1 in the smallest msgpack
forms. Arrays above Flax's chunk size (1 GiB), which Flax would split,
are refused.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Mapping

import numpy as np

EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)                        # ext 8/16/32
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if 0xD4 <= b <= 0xD8:                         # fixext 1..16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack: ext type {code} is not an ndarray "
                             "(the only ext type this reader takes)")
        shape, dtype, buf = loads(payload)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(
            tuple(shape)).copy()


_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


def loads(data: bytes) -> Any:
    """Decode one msgpack value; raises on trailing bytes."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return out


def load_variables(path: str) -> dict:
    """A Flax variable tree ({"params": ..., ...}, numpy leaves) from a
    file written by ``flax.serialization.to_bytes``."""
    with open(path, "rb") as f:
        tree = loads(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a Flax variable tree")
    return tree



MAX_CHUNK_SIZE = 1 << 30


def _head(out: bytearray, n: int, fix: int, fix_max: int, sized):
    """A map / array / str / bin / ext length header: the fix form below
    ``fix_max`` (when there is one), else the smallest sized form."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in sized:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} too large")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} too small")


def _pack(out: bytearray, v: Any) -> None:
    if isinstance(v, int) and not isinstance(v, bool):
        _int(out, v)
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _head(out, len(data), 0xA0, 32, _STR)
        out += data
    elif isinstance(v, (bytes, bytearray)):
        _head(out, len(v), None, 0, _BIN)
        out += v
    elif isinstance(v, tuple):
        _head(out, len(v), 0x90, 16, _ARRAY)
        for x in v:
            _pack(out, x)
    elif isinstance(v, Mapping):
        _head(out, len(v), 0x80, 16, _MAP)
        for k, x in v.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map key {k!r} is not a str")
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, np.ndarray):
        if v.dtype.hasobject or v.dtype.isalignedstruct:
            raise ValueError("msgpack: object and structured dtypes are "
                             "not written")
        if v.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(f"msgpack: an array of {v.nbytes} bytes is "
                             "above Flax's chunk size")
        payload = dumps((tuple(int(d) for d in v.shape), v.dtype.name,
                         v.tobytes("C")))
        if len(payload) in _FIXEXT:
            out.append(_FIXEXT[len(payload)])
        else:
            _head(out, len(payload), None, 0, _EXT)
        out += struct.pack(">b", EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"msgpack: cannot write {type(v).__name__}")


def dumps(value: Any) -> bytes:
    """Encode one value of a Flax variable tree: maps with str keys,
    ndarray leaves as Flax's ext 1 (its payload a tuple of ints, a str and
    bytes); anything else raises TypeError."""
    out = bytearray()
    _pack(out, value)
    return bytes(out)


def save_variables(path: str, variables: Mapping) -> str:
    """Write a Flax variable tree ({"params": ..., ...}, numpy leaves) as
    ``flax.serialization.to_bytes`` would, for the JAX package's
    ``checkpoint.load_variables`` and this module's ``load_variables``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(dumps(variables))
    return path
