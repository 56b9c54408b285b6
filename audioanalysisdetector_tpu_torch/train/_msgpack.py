"""A numpy-only reader of flax's msgpack checkpoints (no ``msgpack``, no ``flax``).

The JAX package writes checkpoints with ``flax.serialization.to_bytes``
(``train/checkpoint.py::save_checkpoint``): a msgpack document of maps,
arrays and scalars whose array leaves are msgpack ext values. This module
decodes that format with the standard library and numpy alone, so the port
reads JAX-trained weights on a machine that has neither package, and it
returns what ``flax.serialization.msgpack_restore`` returns:

- msgpack nil, bool, int, float, str, bin, array (a list) and map (a dict);
- ext type 1, an ndarray: a packed ``(shape, dtype name, C-order bytes)``;
- ext type 2, a Python complex: a packed ``(real, imag)``;
- ext type 3, a numpy scalar: an ndarray of shape ``()``, unwrapped;
- ``{"__msgpack_chunked_array__": True, "shape", "chunks"}`` maps, which flax
  writes for arrays over its ``MAX_CHUNK_SIZE``, joined back into one array
  (at the top level and in maps, where flax's own restore joins them).

numpy has no bfloat16: such a leaf is read through ``uint16`` and returned
as a ``torch.bfloat16`` tensor of the same shape (a 0-d tensor for a scalar).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class MsgpackFormatError(ValueError):
    """The bytes are not a msgpack document this reader understands."""


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackFormatError(f"truncated msgpack: {n} bytes wanted at offset {self.pos}")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
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
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", self.bin), 0xC5: (">H", self.bin), 0xC6: (">I", self.bin),
            0xD9: (">B", self.str), 0xDA: (">H", self.str), 0xDB: (">I", self.str),
            0xDC: (">H", self.array), 0xDD: (">I", self.array),
            0xDE: (">H", self.map), 0xDF: (">I", self.map),
        }
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        numbers = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        if 0xC7 <= b <= 0xC9:  # ext 8, 16, 32
            return self.ext(self.unpack((">B", ">H", ">I")[b - 0xC7]))
        raise MsgpackFormatError(f"unknown msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_COMPLEX:
            re, im = loads(data)
            return complex(re, im)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise MsgpackFormatError(f"unknown msgpack ext type {code}")


def _ndarray(data: bytes):
    """flax's array payload: a packed (shape, dtype name, C-order bytes)."""
    shape, name, buf = loads(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").reshape(shape)
        return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def loads(data: bytes):
    """One msgpack document -> Python values (flax's ext types decoded)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise MsgpackFormatError(f"{len(reader.data) - reader.pos} trailing bytes after the document")
    return out


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """Join chunked array leaves, where flax's ``msgpack_restore`` does."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_leaves(v)
    return d


def msgpack_restore(data: bytes):
    """``flax.serialization.msgpack_restore`` without flax or msgpack."""
    return _unchunk_leaves(loads(data))
