"""A reader for the msgpack files that Flax writes (``flax.serialization.
to_bytes``), in Python and numpy alone: the port imports neither flax nor
the ``msgpack`` package, and the GPU machine need not have either.

It decodes the subset those files use: maps, arrays, strings, bin, ints,
floats, nil and booleans, and Flax's ext type 1, an ndarray whose payload
is itself msgpack of ``(shape, dtype name, raw buffer)``. Any other ext
code (Flax's complex numbers and numpy scalars, say) raises.
"""

from __future__ import annotations

import struct
from typing import Any

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

