"""The subset of msgpack that `flax.serialization.msgpack_serialize` writes,
in plain Python, with tensors for its array leaves.

`.vtpu` checkpoints (`checkpoints.py`) are flax's msgpack: nil, bools, ints,
float32/float64, str, bin, arrays and maps in every width, and arrays as
ext type 1, whose payload is itself msgpack of (shape, dtype name, C-order
bytes). A leaf over `MAX_CHUNK_SIZE` bytes is a map
`{"__msgpack_chunked_array__": True, "shape": {"0": .., ..}, "chunks":
{"0": flat array, ..}}`. The machine with the card has no `msgpack` package
and numpy has no bfloat16 there, so array leaves are read into CPU torch
tensors, bfloat16 as `torch.bfloat16`, each with one copy out of the file's
buffer. An ext type or a dtype name not listed here raises.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO, List, Mapping

import numpy as np
import torch

EXT_NDARRAY = 1
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"

DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64,
}
_NAMES = {v: k for k, v in DTYPES.items()}

_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


# ---------------------------------------------------------------- decode


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def unpack(self) -> Any:
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (b - 0xC7))
            return self.ext(n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return int.from_bytes(self.take(1 << (b - 0xD0)), "big", signed=True)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self.text(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not part of the format")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.unpack() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.unpack()
            out[key] = self.unpack()
        return out

    def ext(self, n: int) -> torch.Tensor:
        code = int.from_bytes(self.take(1), "big", signed=True)
        payload = self.take(n)
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not an ndarray (type {EXT_NDARRAY})")
        return _array_from_payload(payload)


def _array_from_payload(payload: memoryview) -> torch.Tensor:
    """flax's `_ndarray_from_bytes`: msgpack (shape, dtype name, bytes)."""
    inner = _Reader(payload)
    head = inner.uint(1)
    if head != 0x93:
        raise ValueError("an ndarray payload must be a 3-element array")
    shape = inner.unpack()
    name = inner.unpack()
    name = name.decode() if isinstance(name, bytes) else name
    if name not in DTYPES:
        raise ValueError(f"array dtype {name!r} is not one of {sorted(DTYPES)}")
    b = inner.uint(1)
    if b not in (0xC4, 0xC5, 0xC6):
        raise ValueError("an ndarray payload must end in its bytes (bin)")
    data = inner.take(inner.uint(1 << (b - 0xC4)))
    dtype = DTYPES[name]
    if int(np.prod(shape, dtype=np.int64)) * dtype.itemsize != len(data):
        raise ValueError(f"array of shape {shape} {name} does not fit {len(data)} bytes")
    if not len(data):
        return torch.empty(shape, dtype=dtype)
    raw = np.frombuffer(data, dtype=np.uint8).copy()  # the one copy
    return torch.from_numpy(raw).view(dtype).reshape(shape)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data) -> Any:
    """Decode msgpack bytes (any buffer); array leaves become tensors and
    chunked arrays are joined."""
    reader = _Reader(memoryview(data).cast("B"))
    out = reader.unpack()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return _unchunk(out)


# ---------------------------------------------------------------- encode


def _uint_head(n: int, codes) -> bytes:
    """The header of a str, bin, array, map or ext of length n in its 8, 16
    or 32 bit length form (`codes`, None where the type has no such form)."""
    for width, code in zip((1, 2, 4), codes):
        if code is not None and n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"a msgpack object of length {n} is too long")


class _Writer:
    def __init__(self):
        self.parts: List = []

    def pack(self, obj: Any) -> None:
        put = self.parts.append
        if obj is None:
            put(b"\xc0")
        elif obj is True or obj is False:
            put(b"\xc3" if obj else b"\xc2")
        elif isinstance(obj, int):
            put(_pack_int(obj))
        elif isinstance(obj, float):
            put(b"\xcb" + struct.pack(">d", obj))
        elif isinstance(obj, str):
            raw = obj.encode("utf-8")
            put(bytes([0xA0 | len(raw)]) if len(raw) < 32
                else _uint_head(len(raw), (0xD9, 0xDA, 0xDB)))
            put(raw)
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            raw = memoryview(obj).cast("B")
            put(_uint_head(len(raw), (0xC4, 0xC5, 0xC6)))
            put(raw)
        elif isinstance(obj, (list, tuple)):
            put(bytes([0x90 | len(obj)]) if len(obj) < 16
                else _uint_head(len(obj), (None, 0xDC, 0xDD)))
            for x in obj:
                self.pack(x)
        elif isinstance(obj, Mapping):
            put(bytes([0x80 | len(obj)]) if len(obj) < 16
                else _uint_head(len(obj), (None, 0xDE, 0xDF)))
            for k, v in obj.items():
                self.pack(k)
                self.pack(v)
        elif isinstance(obj, (torch.Tensor, np.ndarray)):
            self.pack_array(obj)
        else:
            raise TypeError(f"cannot msgpack a {type(obj).__name__}")

    def pack_array(self, x) -> None:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        t = t.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"array dtype {t.dtype} is not one of {sorted(DTYPES)}")
        nbytes = t.numel() * t.element_size()
        if nbytes > MAX_CHUNK_SIZE:  # flax's chunked form, as its writer makes it
            per = max(1, MAX_CHUNK_SIZE // t.element_size())
            flat = t.reshape(-1)
            self.pack({CHUNKED: True, "shape": {str(i): n for i, n in enumerate(t.shape)},
                       "chunks": {str(i): flat[j: j + per]
                                  for i, j in enumerate(range(0, flat.numel(), per))}})
            return
        inner = _Writer()
        inner.parts.append(b"\x93")  # (shape, dtype name, bytes)
        inner.pack(list(t.shape))
        inner.pack(_NAMES[t.dtype])
        inner.parts.append(_uint_head(nbytes, (0xC4, 0xC5, 0xC6)))
        head = b"".join(inner.parts)
        n = len(head) + nbytes
        put = self.parts.append
        if n in _FIXEXT:
            put(bytes([_FIXEXT[n], EXT_NDARRAY]))
        else:
            put(_uint_head(n, (0xC7, 0xC8, 0xC9)) + bytes([EXT_NDARRAY]))
        put(head)
        if nbytes:
            put(t.reshape(-1).view(torch.uint8).numpy().data)


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return bytes([n & 0xFF])
    if n >= 0:
        for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if n < 1 << (8 * width):
                return bytes([code]) + n.to_bytes(width, "big")
    else:
        for code, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if n >= -(1 << (8 * width - 1)):
                return bytes([code]) + n.to_bytes(width, "big", signed=True)
    raise ValueError(f"integer {n} does not fit 64 bits")


def packb(obj: Any) -> bytes:
    """Encode `obj` (None, bool, int, float, str, bytes, lists, tuples,
    mappings and tensors or numpy arrays) as msgpack bytes."""
    w = _Writer()
    w.pack(obj)
    return b"".join(w.parts)


def pack_into(f: BinaryIO, obj: Any) -> None:
    """`packb` written to `f` piece by piece: array bytes are not copied."""
    w = _Writer()
    w.pack(obj)
    for part in w.parts:
        f.write(part)
