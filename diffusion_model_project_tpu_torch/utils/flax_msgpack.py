"""Read flax's msgpack checkpoints (``flax.serialization.msgpack_serialize``)
without flax or msgpack: a plain Python + numpy decoder, read-only.

It takes the msgpack types such a file holds: nil, booleans, ints of every
width (signed or not), float32/64, str, bin 8/16/32, arrays and maps, and
flax's ext types 1 (an ndarray: the msgpack of ``(shape, dtype name, C-order
bytes)``) and 3 (a numpy scalar, stored as a 0-d ndarray). flax's chunked
leaves (``{'__msgpack_chunked_array__': True, 'shape': ..., 'chunks': ...}``,
arrays larger than its ``MAX_CHUNK_SIZE``) are joined back into one array.
Any other type raises ``ValueError``.

Leaves come back as numpy arrays, as ``flax.serialization.msgpack_restore``
gives them, except ``bfloat16``, which numpy lacks: such a leaf is decoded
as ``uint16`` and viewed as a ``torch.bfloat16`` tensor.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _obj(r: _Reader, raw: bool) -> Any:
    """One msgpack object. ``raw``: strings stay bytes (flax unpacks the
    inside of an ndarray ext so)."""
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_obj(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r, b & 0x1F, raw)
    fixed = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in fixed:
        return fixed[b]
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
    if b in ints:
        return r.unpack(ints[b])
    lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin 8/16/32
               0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str 8/16/32
               0xDC: ">H", 0xDD: ">I",                  # array 16/32
               0xDE: ">H", 0xDF: ">I"}                  # map 16/32
    if b in lengths:
        n = r.unpack(lengths[b])
        if b <= 0xC6:
            return bytes(r.take(n))
        if b <= 0xDB:
            return _str(r, n, raw)
        if b <= 0xDD:
            return [_obj(r, raw) for _ in range(n)]
        return _map(r, n, raw)
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        return _ext(r.unpack(">b"), r.take(fixext[b]))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _str(r: _Reader, n: int, raw: bool):
    s = bytes(r.take(n))
    return s if raw else s.decode("utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _obj(r, raw)
        out[k] = _obj(r, raw)
    return out


def _ndarray(data: memoryview):
    r = _Reader(bytes(data))
    shape, dtype_name, buffer = _obj(r, raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _dict_to_tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        chunks = _dict_to_tuple(tree["chunks"])
        flat = (torch.cat(chunks) if isinstance(chunks[0], torch.Tensor)
                else np.concatenate(chunks))
        return flat.reshape(_dict_to_tuple(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes):
    """The tree of a flax msgpack checkpoint's bytes."""
    r = _Reader(data)
    tree = _obj(r, raw=False)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)


def load(path: str):
    """The tree of the flax msgpack checkpoint at ``path``."""
    with open(path, "rb") as f:
        return restore(f.read())
