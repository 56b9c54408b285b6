"""A numpy-only reader and writer of flax's msgpack checkpoints (no ``msgpack``, no ``flax``).

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

``to_bytes`` is the inverse, ``flax.serialization.to_bytes`` of a state dict
without flax or msgpack: the same bytes for the same tree (dicts in their
insertion order, each value in msgpack's smallest encoding, arrays over
``MAX_CHUNK_SIZE`` bytes chunked as flax chunks them). A ``torch.bfloat16``
tensor is written as flax writes a bfloat16 array.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
# flax.serialization.MAX_CHUNK_SIZE: arrays over it are written in chunks
MAX_CHUNK_SIZE = 2**30


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


def _sized(out: list, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    form (``codes`` lists the type bytes with 8 bits first, or 16 first)."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    widths = ((0xFF, ">B"), (0xFFFF, ">H"), (0xFFFFFFFF, ">I"))[3 - len(codes):]
    for (limit, fmt), code in zip(widths, codes):
        if n <= limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise MsgpackFormatError(f"{n} items or bytes are too many for msgpack")


def _int(out: list, v: int) -> None:
    if -32 <= v <= 0x7F:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if v > 0 else (
        (0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for code, fmt in forms:
        try:
            out.append(bytes([code]) + struct.pack(fmt, v))
            return
        except struct.error:
            continue
    raise MsgpackFormatError(f"integer {v} does not fit 64 bits")


def _ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    if n in (1, 2, 4, 8, 16):
        out.append(bytes([0xD4 + (n.bit_length() - 1), code & 0xFF]))
    else:
        _sized(out, n, None, -1, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", code))
    out.append(data)


def _array_bytes(a: np.ndarray | torch.Tensor) -> bytes:
    """flax's array payload: a packed (shape, dtype name, C-order bytes)."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.bfloat16:
            return _array_bytes(a.detach().cpu().numpy())
        bits = a.detach().cpu().contiguous().view(torch.int16).numpy()
        return dumps((list(a.shape), "bfloat16", bits.astype("<i2").tobytes()))
    if a.dtype.hasobject:
        raise MsgpackFormatError("object arrays are not serialisable")
    return dumps((list(a.shape), a.dtype.name, a.tobytes("C")))


def _pack(out: list, v) -> None:
    if v is None or isinstance(v, bool):
        out.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[v])
    elif isinstance(v, np.generic):  # before int and float: np.float64 is a float
        _ext(out, _EXT_NPSCALAR, _array_bytes(np.asarray(v)))
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _sized(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(v, (bytes, bytearray)):
        _sized(out, len(v), None, -1, (0xC4, 0xC5, 0xC6))
        out.append(bytes(v))
    elif isinstance(v, (list, tuple)):
        _sized(out, len(v), 0x90, 15, (0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _sized(out, len(v), 0x80, 15, (0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        _ext(out, _EXT_NDARRAY, _array_bytes(v))
    elif isinstance(v, complex):
        _ext(out, _EXT_COMPLEX, dumps((v.real, v.imag)))
    else:
        raise MsgpackFormatError(f"cannot serialise {type(v).__name__}")


def dumps(obj) -> bytes:
    """Python values (flax's ext types included) -> one msgpack document."""
    out: list[bytes] = []
    _pack(out, obj)
    return b"".join(out)


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.size * a.dtype.itemsize


def _chunk(a):
    """An oversized array as flax's chunk map."""
    itemsize = a.element_size() if isinstance(a, torch.Tensor) else a.dtype.itemsize
    chunk = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = a.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(j): flat[i : i + chunk] for j, i in enumerate(range(0, n, chunk))}}


def _chunked(tree, top: bool = True):
    """The tree with oversized arrays chunked where flax chunks them (the
    top level and dict values), as a copy."""
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return _chunk(tree) if top and _nbytes(tree) > MAX_CHUNK_SIZE else tree
    if isinstance(tree, dict):
        return {k: _chunked(v, isinstance(v, (np.ndarray, torch.Tensor, dict))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_chunked(v, False) for v in tree)
    return tree


def to_bytes(state_dict) -> bytes:
    """``flax.serialization.to_bytes`` of a state dict (its
    ``msgpack_serialize(state_dict, in_place=True)``) without flax or
    msgpack: dicts keep their insertion order."""
    return dumps(_chunked(state_dict))
