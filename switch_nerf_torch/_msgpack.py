"""The msgpack codec of the JAX package's checkpoints, in plain Python.

``flax.serialization`` writes a train state as msgpack: maps with str keys,
arrays, str, bin, ints, floats, nil and bool, with every array as ext type
1, a packed ``[shape, dtype name, raw little-endian C-order bytes]``, and
numpy scalars as ext type 3 with the same payload. This module reads and
writes that subset, so the port needs neither ``msgpack`` nor ``flax``:

    data = packb(tree)        # byte-for-byte what flax writes for the tree
    tree = unpackb(data)      # arrays as numpy (bfloat16 as torch tensors)

Leaves that ``packb`` takes: dict, list/tuple, str, bytes, bool, int,
float, None, numpy arrays and scalars, and torch tensors (moved to the CPU;
``torch.bfloat16`` is written under the dtype name "bfloat16", which numpy
lacks, and read back into a ``torch.bfloat16`` tensor). flax splits an
array leaf above 2**30 bytes into chunks; no leaf of the supported models
comes near that, and ``packb`` refuses one.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

MAX_LEAF_BYTES = 2 ** 30        # flax chunks array leaves above this
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ------------------------------------------------------------------ encode --

def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack("b", n)
    elif n >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} too large for msgpack")
    else:
        for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if n >= -limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} too small for msgpack")


def _pack_len(n: int, fix: int, fix_limit: int, codes, out: bytearray) -> None:
    """A length header: fix | n below fix_limit (fix None: no fix form),
    else the 8/16/32-bit form of `codes` (an 8-bit code of None: none)."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, None, 0, (0xc7, 0xc8, 0xc9), out)
    out += struct.pack("b", code)
    out += data


def _array_payload(arr) -> bytes:
    """packb((shape, dtype name, raw bytes)), as flax's _ndarray_to_bytes."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return packb((tuple(t.shape), "bfloat16",
                          t.view(torch.int16).numpy().tobytes()))
        arr = t.numpy()
    arr = np.asarray(arr)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.nbytes


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int) and not isinstance(obj, np.integer):
        _pack_int(int(obj), out)
    elif isinstance(obj, float) and not isinstance(obj, np.floating):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), None, 0, (0xc4, 0xc5, 0xc6), out)
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xdc, 0xdd), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xde, 0xdf), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        if _nbytes(obj) > MAX_LEAF_BYTES:
            raise ValueError(f"array leaf of {_nbytes(obj)} bytes: flax "
                             "would chunk it, which this codec does not")
        _pack_ext(_EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of `obj` (see the module docstring for the leaves)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ------------------------------------------------------------------ decode --

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED_EXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def _ext(code: int, data: bytes):
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, name, buf = unpackb(data)
        if name == "bfloat16":
            arr = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
            return arr.reshape(tuple(shape))
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]
    raise ValueError(f"msgpack ext type {code} is not supported")


def _read(r: _Reader) -> Any:
    b = r.unpack(">B")
    if b < 0x80:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        kind, n = "map", b & 0x0f
    elif 0x90 <= b <= 0x9f:
        kind, n = "array", b & 0x0f
    elif 0xa0 <= b <= 0xbf:
        kind, n = "str", b & 0x1f
    elif b == 0xc0:
        return None
    elif b in (0xc2, 0xc3):
        return b == 0xc3
    elif b in _SCALARS:
        return r.unpack(_SCALARS[b])
    elif b in _FIXED_EXT:
        kind, n = "ext", _FIXED_EXT[b]
    elif b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
    if kind == "map":
        out = {}
        for _ in range(n):
            k = _read(r)
            out[k] = _read(r)
        return out
    if kind == "array":
        return [_read(r) for _ in range(n)]
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    code = r.unpack("b")
    return _ext(code, bytes(r.take(n)))


def unpackb(data: bytes) -> Any:
    """The object msgpack bytes hold; arrays as numpy, bfloat16 arrays as
    torch tensors. Extra bytes after it raise."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         "msgpack object")
    return obj
