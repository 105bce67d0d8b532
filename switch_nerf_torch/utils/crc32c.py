"""CRC32C (Castagnoli) over numpy lanes.

The checksum of the TFRecord framing (``datasets/tfrecord.py``) and of the
OCDBT files of an orbax checkpoint (``ocdbt.py``). A record or a data file
runs to tens of MB, so the CRC runs over thousands of lanes at once in
numpy, never a Python loop over its bytes.
"""
from __future__ import annotations

import numpy as np

__all__ = ["crc32c"]

_POLY = 0x82F63B78          # CRC32C (Castagnoli), reflected


def _make_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(_POLY),
                         table >> 1).astype(np.uint32)
    return table


_TABLE = _make_table()


def _raw_crc(data: np.ndarray) -> int:
    """The CRC register after `data` from 0, no final xor (a linear map).

    The bytes are cut into K equal lanes, zeros padded in front (which leave
    a register that starts at 0 unchanged); the lanes advance together one
    byte a step, then pairs of neighbouring lanes are joined: the left
    lane's register is carried over the right lane's length of zero bytes
    (a 32 x 32 GF(2) map, squared at each level) and xor-ed into the
    right's."""
    n = data.size
    lanes = 1
    while lanes * lanes * 4 < n and lanes < 1 << 14:
        lanes *= 2
    width = -(-n // lanes)
    padded = np.zeros(lanes * width, np.uint8)
    padded[lanes * width - n:] = data
    block = padded.reshape(lanes, width)
    reg = np.zeros(lanes, np.uint32)
    for i in range(width):
        reg = _TABLE[(reg ^ block[:, i]) & 0xFF] ^ (reg >> 8)
    # columns of the map "advance the register over `width` zero bytes"
    shift = np.array([1 << b for b in range(32)], np.uint32)
    for _ in range(width):
        shift = _TABLE[shift & 0xFF] ^ (shift >> 8)
    while reg.size > 1:
        left, right = reg[0::2], reg[1::2]
        reg = _apply(shift, left) ^ right
        shift = _apply(shift, shift)        # twice as many zero bytes
    return int(reg[0])


def _apply(columns: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The GF(2) map with the given 32 columns applied to each of v."""
    out = np.zeros_like(v)
    for b in range(32):
        out ^= np.where((v >> np.uint32(b)) & 1, columns[b], np.uint32(0))
    return out


def crc32c(data: bytes) -> int:
    """CRC32C of `data` (init 0xFFFFFFFF, final xor 0xFFFFFFFF)."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size < 4:
        reg = 0xFFFFFFFF
        for byte in buf.tolist():
            reg = int(_TABLE[(reg ^ byte) & 0xFF]) ^ (reg >> 8)
        return reg ^ 0xFFFFFFFF
    # the initial register 0xFFFFFFFF is the first four bytes xor-ed with it
    head = buf.copy()
    head[:4] ^= np.uint8(0xFF)
    return _raw_crc(head) ^ 0xFFFFFFFF
