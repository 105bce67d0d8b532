"""GZIP TFRecord files of ``tf.train.Example`` records, without TensorFlow.

The Block-NeRF (Waymo) scenes come as GZIP tfrecords. The JAX package
reads them through ``tf.data.TFRecordDataset(..., "GZIP")``,
``tf.io.parse_single_example``, ``tf.sparse.to_dense`` and
``tf.io.decode_png`` (``switch_nerf_tpu/datasets/block_filesystem_dataset.py``
``handle_one_record``). The port's machines have neither TensorFlow nor
protobuf, so this module holds what the loader needs of them:

  * the TFRecord framing: a little-endian uint64 length, the masked CRC32C
    of those 8 bytes, the data, the masked CRC32C of the data. Both CRCs
    are checked on read. A record of full-resolution ray origins and
    directions runs to tens of MB, so the CRC of the data runs over
    thousands of lanes at once in numpy (``utils/crc32c.py``), never a
    Python loop over its bytes;
  * the ``tf.train.Example`` wire format: the ``features`` map of
    ``Feature`` values (``bytes_list``, ``float_list``, ``int64_list``),
    packed and unpacked repeated fields, int64 varints (negative ones take
    ten bytes);
  * a writer of the same format (packed, as TensorFlow writes), used to
    build synthetic scenes;
  * ``decode_png``: PIL, always three dimensions [H, W, C] as
    ``tf.io.decode_png(..., channels=0)`` gives.
"""
from __future__ import annotations

import gzip
import io
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np

from switch_nerf_torch.utils.crc32c import crc32c

__all__ = ["crc32c", "masked_crc32c", "read_records", "write_records",
           "parse_example", "encode_example", "read_examples",
           "write_examples", "decode_png", "encode_png"]


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------- framing ---
def read_records(path: Union[str, Path]) -> Iterator[bytes]:
    """Each record's data of a GZIP TFRecord file, in file order; a CRC
    that does not match, or a file cut inside a record, raises
    ValueError."""
    with gzip.open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"{path}: truncated record header")
            length, = struct.unpack("<Q", head[:8])
            if struct.unpack("<I", head[8:])[0] != masked_crc32c(head[:8]):
                raise ValueError(f"{path}: corrupted record length")
            data = f.read(length)
            tail = f.read(4)
            if len(data) < length or len(tail) < 4:
                raise ValueError(f"{path}: truncated record")
            if struct.unpack("<I", tail)[0] != masked_crc32c(data):
                raise ValueError(f"{path}: corrupted record data")
            yield data


def write_records(path: Union[str, Path], records) -> None:
    """A GZIP TFRecord file of the given records' data."""
    with gzip.open(path, "wb") as f:
        for data in records:
            head = struct.pack("<Q", len(data))
            f.write(head)
            f.write(struct.pack("<I", masked_crc32c(head)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc32c(data)))


# ---------------------------------------------------- protobuf wire ---
def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a message: an int
    for a varint, the bytes of a fixed-width or length-delimited one."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if pos > end:
            raise ValueError("message cut inside a field")
        yield field, wire, value


def _packed_varints(buf: bytes) -> np.ndarray:
    """A packed run of varints as int64 (two's complement), vectorised."""
    b = np.frombuffer(buf, np.uint8)
    if b.size == 0:
        return np.zeros(0, np.int64)
    ends = np.flatnonzero(b < 0x80)
    if ends.size == 0 or ends[-1] != b.size - 1:
        raise ValueError("packed varints cut short")
    starts = np.concatenate([[0], ends[:-1] + 1])
    group = np.repeat(np.arange(ends.size), ends - starts + 1)
    pos = np.arange(b.size) - starts[group]
    if pos.max() > 9:
        raise ValueError("varint longer than 10 bytes")
    parts = (b & 0x7F).astype(np.uint64) << (7 * pos).astype(np.uint64)
    return np.add.reduceat(parts, starts).view(np.int64)


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _parse_feature(buf: bytes):
    """A Feature: ("bytes", [bytes]) / ("float", float32 array) /
    ("int64", int64 array); an empty Feature is an empty float list."""
    for field, wire, value in _fields(buf):
        if wire != 2 or field not in (1, 2, 3):
            continue
        if field == 1:
            return "bytes", [v for f, w, v in _fields(value)
                             if f == 1 and w == 2]
        floats: List[np.ndarray] = []
        ints: List[np.ndarray] = []
        for f, w, v in _fields(value):
            if f != 1:
                continue
            if field == 2:
                floats.append(np.frombuffer(v, "<f4") if w in (2, 5)
                              else np.zeros(0, np.float32))
            elif w == 2:
                ints.append(_packed_varints(v))
            else:
                ints.append(np.array([_signed(v)], np.int64))
        if field == 2:
            return "float", (np.concatenate(floats).astype(np.float32)
                             if floats else np.zeros(0, np.float32))
        return "int64", (np.concatenate(ints) if ints
                         else np.zeros(0, np.int64))
    return "float", np.zeros(0, np.float32)


def parse_example(buf: bytes) -> Dict[str, tuple]:
    """A serialized tf.train.Example -> {key: (kind, values)}, kind one of
    "bytes" (a list of bytes), "float" (float32 array) or "int64" (int64
    array)."""
    out: Dict[str, tuple] = {}
    for field, wire, features in _fields(buf):
        if field != 1 or wire != 2:
            continue
        for f, w, entry in _fields(features):
            if f != 1 or w != 2:
                continue
            key, value = None, b""
            for ef, ew, ev in _fields(entry):
                if ef == 1 and ew == 2:
                    key = bytes(ev).decode()
                elif ef == 2 and ew == 2:
                    value = ev
            if key is not None:
                out[key] = _parse_feature(value)
    return out


def _key(field: int, wire: int) -> bytes:
    return _encode_varint((field << 3) | wire)


def _encode_varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _delimited(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _encode_varint(len(payload)) + payload


def encode_example(features: Dict[str, tuple]) -> bytes:
    """{key: (kind, values)} as parse_example returns it -> a serialized
    tf.train.Example, repeated numbers packed (as TensorFlow writes)."""
    entries = []
    for key, (kind, values) in features.items():
        if kind == "bytes":
            body = b"".join(_delimited(1, bytes(v)) for v in values)
            feature = _delimited(1, body)
        elif kind == "float":
            body = np.asarray(values, "<f4").reshape(-1).tobytes()
            feature = _delimited(2, _delimited(1, body))
        elif kind == "int64":
            body = b"".join(_encode_varint(int(v)) for v in
                            np.asarray(values).reshape(-1))
            feature = _delimited(3, _delimited(1, body))
        else:
            raise ValueError(f"feature kind {kind!r}")
        entries.append(_delimited(1, _delimited(1, key.encode())
                                  + _delimited(2, feature)))
    return _delimited(1, b"".join(entries))


def read_examples(path) -> Iterator[Dict[str, tuple]]:
    for record in read_records(path):
        yield parse_example(record)


def write_examples(path, examples) -> None:
    write_records(path, (encode_example(e) for e in examples))


# --------------------------------------------------------------- PNG ---
def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C], the file's own channels (C = 1 for a
    grey image), as tf.io.decode_png(..., channels=0)."""
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        arr = np.asarray(im)
    if arr.dtype != np.uint8:
        raise ValueError(f"PNG of {arr.dtype} samples; uint8 expected")
    return arr[..., None] if arr.ndim == 2 else arr


def encode_png(image: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    arr = np.asarray(image, np.uint8)
    Image.fromarray(arr[..., 0] if arr.ndim == 3 and arr.shape[-1] == 1
                    else arr).save(buf, format="PNG")
    return buf.getvalue()
