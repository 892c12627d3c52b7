"""Read and write flax's msgpack checkpoints (``flax.serialization.
msgpack_serialize`` / ``msgpack_restore``) without flax or msgpack: a plain
Python + numpy decoder (``restore``, ``load``) and encoder
(``msgpack_serialize``), whose bytes equal flax's for the same tree.

It takes the msgpack types such a file holds: nil, booleans, ints of every
width (signed or not), float32/64, str, bin 8/16/32, arrays and maps, and
flax's ext types 1 (an ndarray: the msgpack of ``(shape, dtype name, C-order
bytes)``) and 3 (a numpy scalar, stored as a 0-d ndarray). flax's chunked
leaves (``{'__msgpack_chunked_array__': True, 'shape': ..., 'chunks': ...}``,
arrays larger than its ``MAX_CHUNK_SIZE``) are joined back into one array.
Any other type raises ``ValueError``.

Leaves come back as numpy arrays, as ``flax.serialization.msgpack_restore``
gives them, except ``bfloat16``, which numpy lacks: such a leaf is decoded
as ``uint16`` and viewed as a ``torch.bfloat16`` tensor. The encoder takes
numpy arrays and scalars, torch tensors (on any device; ``bfloat16`` is
written under that name, as flax writes it), and Python None, bools, ints,
floats, strings, bytes, lists and string-keyed dicts.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
# flax's limit for one array leaf; larger ones are written as chunks of it
MAX_CHUNK_SIZE = 2 ** 30


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


# ------------------------------------------------------------------- writing


def _pack_uint(n: int, codes) -> bytes:
    """The shortest of the length headers ``codes`` (8/16/32-bit) holding n."""
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if n <= limit:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, limit in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                                 (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
            if n >= -limit:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"int {n} out of msgpack's range")


def _header(n: int, fix: int, fix_max: int, codes) -> bytes:
    return bytes([fix | n]) if n <= fix_max else _pack_uint(n, codes)


def _str_bytes(s: str) -> bytes:
    b = s.encode("utf-8")
    return _header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin(b: bytes) -> bytes:
    return _pack_uint(len(b), (0xC4, 0xC5, 0xC6)) + b


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _pack_uint(n, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _as_numpy(x):
    """(C-ordered numpy array, dtype name) of an array leaf; a bfloat16
    tensor is its uint16 bits under the name 'bfloat16'."""
    name = None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x, name = x.view(torch.uint16), "bfloat16"
        x = x.numpy()
    # np.require keeps 0-d arrays 0-d (np.ascontiguousarray would not)
    return np.require(x, requirements="C"), name or x.dtype.name


def _pack_ndarray(x, code: int, out: list) -> None:
    """An ext ``code`` holding flax's ``_ndarray_to_bytes``: the msgpack of
    (shape, dtype name, C-order bytes). The data goes into ``out`` as a view,
    copied once, by the final join."""
    arr, name = _as_numpy(x)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    data = memoryview(arr.reshape(-1)).cast("B")
    head = (b"\x93" + _header(arr.ndim, 0x90, 15, (None, 0xDC, 0xDD))
            + b"".join(_int(int(d)) for d in arr.shape) + _str_bytes(name)
            + _pack_uint(data.nbytes, (0xC4, 0xC5, 0xC6)))
    out += [_ext_header(code, len(head) + data.nbytes), head, data]


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _chunked(x) -> dict:
    """flax's ``_chunk``: {'__msgpack_chunked_array__': True, 'shape': ...,
    'chunks': ...}, the flat array cut into MAX_CHUNK_SIZE-byte pieces. flax
    builds it after copying the tree, so its keys stay in this order."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    chunksize = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    chunks = [flat[i:i + chunksize] for i in range(0, n, chunksize)]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _too_large(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size() > MAX_CHUNK_SIZE
    return x.size * x.dtype.itemsize > MAX_CHUNK_SIZE


def _pack(x, out: list, chunk: bool) -> None:
    """Append the msgpack of ``x`` to ``out``. ``chunk``: ``x`` is the root
    or reached from it through dicts only, where flax chunks oversized
    arrays (it leaves whatever lies inside a list alone)."""
    if chunk and _is_array(x) and _too_large(x):
        _pack_map(_chunked(x).items(), out, False)
    elif x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        out.append(_str_bytes(x))
    elif type(x) is bytes:
        out.append(_bin(x))
    elif type(x) is dict:
        # in sorted key order: flax copies the tree with jax.tree_util first
        _pack_map(sorted(x.items()), out, chunk)
    elif type(x) is list:
        out.append(_header(len(x), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in x:
            _pack(v, out, False)
    elif _is_array(x):
        _pack_ndarray(x, _EXT_NDARRAY, out)
    elif isinstance(x, np.generic):
        _pack_ndarray(np.asarray(x), _EXT_NPSCALAR, out)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} to msgpack")


def _pack_map(items, out: list, chunk: bool) -> None:
    items = list(items)
    out.append(_header(len(items), 0x80, 15, (None, 0xDE, 0xDF)))
    for k, v in items:
        _pack(k, out, False)
        _pack(v, out, chunk)


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` writes."""
    out: list = []
    _pack(tree, out, True)
    return b"".join(out)

