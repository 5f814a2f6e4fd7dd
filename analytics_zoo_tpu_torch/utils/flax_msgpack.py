"""flax's msgpack checkpoint format, read and written in pure Python.

The JAX package saves model variables and optimizer state with
``flax.serialization.to_bytes`` (``learn/checkpoint.py``). This module
reads and writes the same bytes without ``msgpack`` or ``flax``, so a
checkpoint crosses between the two packages in both directions.

What ``to_bytes`` emits, and all this module handles:

- msgpack nil, bool, int, float (64-bit), str, bin, array and map;
- flax's ndarray extension, type 1: a msgpack array ``(shape, dtype name,
  C-order bytes)``; type 3, a numpy scalar, the same way;
- flax's chunked layout for an array above ``MAX_CHUNK_SIZE`` bytes (a
  256000 x 2048 f32 embedding is 2 GiB): a map ``{"__msgpack_chunked_array__":
  True, "shape": {"0": d0, ...}, "chunks": {"0": flat part, ...}}``.

A tree to write is in flax's state-dict layout already (dicts keyed by
str; ``learn/checkpoint.py`` builds it), with numpy arrays or tensors as
leaves. Arrays come back as numpy arrays (read-only views of the input
where not chunked), except bfloat16, which numpy lacks: that comes back
as a CPU ``torch.Tensor``.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are written chunked
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ------------------------------------------------------------ encoding --
def _head(out: List[bytes], n: int, fix: int, fix_max: int,
          codes: tuple) -> None:
    """A length or count header: the fix form below ``fix_max``, else
    the 8-, 16- or 32-bit form (``codes``; None where the type has no
    8-bit form)."""
    if n < fix_max:
        out.append(bytes([fix | n]))
    elif n < 0x100 and codes[0] is not None:
        out.append(bytes([codes[0], n]))
    elif n < 0x10000:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _int(out: List[bytes], n: int) -> None:
    if 0 <= n < 0x80 or -32 <= n < 0:
        out.append(struct.pack(">b" if n < 0 else ">B", n))
    elif n >= 0:
        for code, fmt, top in ((0xcc, ">BB", 0xff), (0xcd, ">BH", 0xffff),
                               (0xce, ">BI", 0xffffffff),
                               (0xcf, ">BQ", 2 ** 64 - 1)):
            if n <= top:
                out.append(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"integer {n} does not fit msgpack")
    else:
        for code, fmt, low in ((0xd0, ">Bb", -2 ** 7), (0xd1, ">Bh", -2 ** 15),
                               (0xd2, ">Bi", -2 ** 31),
                               (0xd3, ">Bq", -2 ** 63)):
            if n >= low:
                out.append(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"integer {n} does not fit msgpack")


def _str(out: List[bytes], s: str) -> None:
    raw = s.encode("utf-8")
    _head(out, len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb))
    out.append(raw)


def _bin_head(out: List[bytes], n: int) -> None:
    _head(out, n, 0, 0, (0xc4, 0xc5, 0xc6))


def _ext_head(out: List[bytes], code: int, n: int) -> None:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    else:
        _head(out, n, 0, 0, (0xc7, 0xc8, 0xc9))
        out.append(bytes([code]))


def _array(out: List[bytes], code: int, arr) -> None:
    """An ndarray extension of type ``code``: flax's ``_ndarray_to_bytes``,
    msgpack of (shape, dtype name, C-order bytes). The bytes go into
    ``out`` as a view of the array, copied once by ``serialize``'s join."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().contiguous()
        # numpy has no bfloat16: its bytes through int16
        name = "bfloat16" if arr.dtype == torch.bfloat16 else None
        shape = tuple(arr.shape)
        arr = (arr.view(torch.int16) if name else arr).numpy()
        name = name or arr.dtype.name
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured arrays have no flax "
                             "msgpack form")
        shape, name = arr.shape, arr.dtype.name
    raw = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    head: List[bytes] = [bytes([0x93])]
    _head(head, len(shape), 0x90, 16, (None, 0xdc, 0xdd))
    for d in shape:
        _int(head, int(d))
    _str(head, name)
    _bin_head(head, len(raw))
    _ext_head(out, code, sum(len(h) for h in head) + len(raw))
    out.extend(head)
    out.append(raw)


def _chunked(arr) -> dict:
    """flax's ``_chunk``: a flat array in parts of at most
    ``MAX_CHUNK_SIZE`` bytes, with its shape."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) \
        else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(
                range(0, flat.shape[0], size))}}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _pack(out: List[bytes], x: Any) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _int(out, x)
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xcb, x))
    elif type(x) is str:
        _str(out, x)
    elif type(x) in (bytes, bytearray, memoryview):
        raw = bytes(x)
        _bin_head(out, len(raw))
        out.append(raw)
    elif type(x) is dict:
        _head(out, len(x), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in x.items():
            _pack(out, k)
            if isinstance(v, (np.ndarray, torch.Tensor)) and \
                    _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunked(v)
            _pack(out, v)
    elif type(x) in (list, tuple):
        _head(out, len(x), 0x90, 16, (None, 0xdc, 0xdd))
        for v in x:
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _array(out, _EXT_NDARRAY, x)
    elif isinstance(x, np.generic):
        _array(out, _EXT_NPSCALAR, np.asarray(x))
    else:
        raise TypeError(f"no flax msgpack form for {type(x).__name__}")


def serialize(tree: Any) -> bytes:
    """flax's ``msgpack_serialize`` of a state-dict tree (maps keep their
    key order; an array above ``MAX_CHUNK_SIZE`` bytes is chunked), with
    each array's bytes copied once, into the result."""
    if isinstance(tree, (np.ndarray, torch.Tensor)) and \
            _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunked(tree)
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


# ------------------------------------------------------------ decoding --
class _Reader:
    def __init__(self, data, raw_str: bool = False):
        self.mv = memoryview(data)
        self.i = 0
        self.raw_str = raw_str

    def take(self, n: int) -> memoryview:
        if self.i + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        part = self.mv[self.i:self.i + n]
        self.i += n
        return part

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def str_(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw_str else raw.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _array_from_payload(data)
            return arr if code == _EXT_NDARRAY else arr[()]
        raise ValueError(f"msgpack extension type {code} is not one this "
                         "reader takes")

    def value(self) -> Any:
        c = self.take(1)[0]
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map_(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return self.array_(c & 0x0f)
        if 0xa0 <= c <= 0xbf:
            return self.str_(c & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        sized = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
                 0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
                 0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
                 0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
                 0xde: ("map", ">H"), 0xdf: ("map", ">I")}
        if c in sized:
            kind, fmt = sized[c]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return {"ext": self.ext, "str": self.str_, "array": self.array_,
                    "map": self.map_}[kind](n)
        if 0xd4 <= c <= 0xd8:
            return self.ext(1 << (c - 0xd4))
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if c in numbers:
            return self.unpack(numbers[c])
        raise ValueError(f"msgpack byte 0x{c:02x} is not a type this "
                         "reader takes")

    def array_(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _array_from_payload(data) -> Any:
    shape, name, raw = _Reader(data, raw_str=True).value()
    name = name.decode("ascii")
    shape = tuple(shape)
    if name == "bfloat16":
        flat = np.frombuffer(raw, dtype=np.int16)
        return torch.from_numpy(flat.copy()).view(torch.bfloat16).reshape(
            shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(node: dict) -> Any:
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    parts = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts).reshape(shape)
    return np.concatenate(parts).reshape(shape)


def _unchunk_tree(node: Any) -> Any:
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def restore(data) -> Any:
    """flax's ``msgpack_restore``: the state-dict tree in ``data``, with
    chunked arrays joined again."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.i != len(reader.mv):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk_tree(tree)
