"""A Zstandard frame decoder (RFC 8878) in Python and numpy.

An orbax checkpoint (``orbax_read.py``) holds zstd frames twice over:
every OCDBT manifest and B-tree node is one behind a small header
(``ocdbt.py``), and every zarr chunk of an array is one (its compressor is
``{"id": "zstd"}``). The card's machine has no ``zstandard`` package, so
the port decodes them itself:

  * frames: the header (window, content size, checksum flag, dictionary
    id), skippable frames, several frames back to back;
  * blocks: raw, RLE and compressed, several a frame, the window being
    the frame's whole output;
  * literals: raw, RLE, and Huffman-coded in 1 or 4 streams, with the
    tree described directly or by FSE-coded weights, and treeless blocks
    that reuse the previous tree;
  * sequences: FSE-coded literal lengths, match lengths and offsets in
    predefined, RLE, FSE-described and repeat modes, and the three
    repeat offsets, all carried from block to block;
  * the optional content checksum (the low 32 bits of XXH64 over the
    frame's output) is verified; a frame that names a dictionary raises,
    as orbax writes none.

The Huffman and FSE decoders read their backward bitstreams through a
Python integer refilled a few bytes at a time, one table lookup a
symbol: incompressible blocks (raw) are a copy, Huffman-coded literals
(fp32 weights and moments) a few MB/s on one core (PERF.md).
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["ZstdError", "decompress", "xxh64"]

_MAGIC = 0xFD2FB528
_BLOCK_MAX = 128 * 1024


class ZstdError(ValueError):
    """A frame that is not valid zstd, or uses what the decoder refuses."""


# ----------------------------------------------------------- bitstreams --

class _BackBits:
    """A backward bitstream (RFC 8878 section 4.1): the bytes as one
    little-endian integer read from its highest bit down, after the
    padding zeros and the 1 that ends the last byte. Reading past the
    start gives zeros and makes ``left`` negative (an overflow)."""
    __slots__ = ("rev", "i", "acc", "n", "left")

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("a bitstream without its end marker")
        self.rev = data[::-1]
        top = self.rev[0]
        self.i = 1
        self.n = top.bit_length() - 1
        self.acc = top & ((1 << self.n) - 1)
        self.left = (len(data) - 1) * 8 + self.n

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        while self.n < k:
            if self.i < len(self.rev):
                chunk = self.rev[self.i:self.i + 8]
                self.i += len(chunk)
                self.acc = (self.acc << (8 * len(chunk))) | int.from_bytes(
                    chunk, "big")
                self.n += 8 * len(chunk)
            else:
                self.acc <<= k - self.n
                self.n = k
        self.n -= k
        v = self.acc >> self.n
        self.acc &= (1 << self.n) - 1
        self.left -= k
        return v


# ------------------------------------------------------------------ FSE --

def _read_fse_counts(data: bytes, pos: int, max_symbol: int, max_log: int
                     ) -> Tuple[List[int], int, int]:
    """An FSE table description (RFC 8878 4.1.1) at data[pos:]: the
    normalized counts (-1 for "less than 1"), the accuracy log and the
    position after it."""
    bit = pos * 8

    def peek(n: int) -> int:
        lo = bit >> 3
        v = int.from_bytes(data[lo:lo + 8], "little") >> (bit & 7)
        return v & ((1 << n) - 1)

    log = peek(4) + 5
    bit += 4
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} > {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description with too many symbols")
        maxv = 2 * threshold - 1 - remaining
        low = peek(nbits - 1)
        if low < maxv:
            value = low
            bit += nbits - 1
        else:
            value = peek(nbits)
            if value >= threshold:
                value -= maxv
            bit += nbits
        prob = value - 1
        remaining -= -prob if prob < 0 else prob
        counts.append(prob)
        if prob == 0:
            while True:                     # runs of zero probabilities
                rep = peek(2)
                bit += 2
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("a corrupt FSE table description")
    return counts, log, (bit + 7) >> 3


class _Fse:
    """An FSE decoding table: per state, the symbol, the bits to read and
    the base of the next state (RFC 8878 4.1.1)."""
    __slots__ = ("log", "sym", "nb", "base")

    def __init__(self, counts: List[int], log: int):
        size = 1 << log
        sym = [0] * size
        high = size - 1
        nxt = [0] * len(counts)
        for s, c in enumerate(counts):
            if c == -1:
                sym[high] = s
                high -= 1
                nxt[s] = 1
            else:
                nxt[s] = c
        step = (size >> 1) + (size >> 3) + 3
        mask, position = size - 1, 0
        for s, c in enumerate(counts):
            for _ in range(max(c, 0)):
                sym[position] = s
                position = (position + step) & mask
                while position > high:
                    position = (position + step) & mask
        if position != 0:
            raise ZstdError("a corrupt FSE table")
        nb, base = [0] * size, [0] * size
        for u in range(size):
            s = sym[u]
            state = nxt[s]
            nxt[s] += 1
            nb[u] = log - (state.bit_length() - 1)
            base[u] = (state << nb[u]) - size
        self.log, self.sym, self.nb, self.base = log, sym, nb, base

    @classmethod
    def rle(cls, symbol: int) -> "_Fse":
        t = cls.__new__(cls)
        t.log, t.sym, t.nb, t.base = 0, [symbol], [0], [0]
        return t


# the predefined distributions (RFC 8878 3.1.1.3.2.2)
_LL_DEFAULT = _Fse([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2,
                    2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = _Fse([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = _Fse([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)

# literal-length and match-length codes: (baseline, extra bits)
_LL_CODES = ([(i, 0) for i in range(16)]
             + [(16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2),
                (32, 3), (40, 3), (48, 4), (64, 6), (128, 7), (256, 8),
                (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13),
                (16384, 14), (32768, 15), (65536, 16)])
_ML_CODES = ([(i + 3, 0) for i in range(32)]
             + [(35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2),
                (51, 3), (59, 3), (67, 4), (83, 4), (99, 5), (131, 7),
                (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12),
                (8195, 13), (16387, 14), (32771, 15), (65539, 16)])


# -------------------------------------------------------------- Huffman --

class _Huffman:
    """A literals Huffman table (RFC 8878 4.2.1): for every max_bits-bit
    prefix, the symbol and its code length."""
    __slots__ = ("max_bits", "sym", "nb")

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w > 0)
        if total == 0:
            raise ZstdError("a Huffman tree without weights")
        max_bits = total.bit_length()
        rest = (1 << max_bits) - total
        if rest & (rest - 1):
            raise ZstdError("a corrupt Huffman tree (the last weight)")
        weights = weights + [rest.bit_length()]
        if max_bits > 11:
            raise ZstdError(f"Huffman codes of {max_bits} bits (> 11)")
        # codes in order of weight, then of symbol: each takes 2^(w-1)
        # entries of the 2^max_bits table
        sym = np.zeros(1 << max_bits, np.uint8)
        nb = np.zeros(1 << max_bits, np.int64)
        pos = 0
        for w in range(1, max_bits + 1):
            for s, ws in enumerate(weights):
                if ws == w:
                    span = 1 << (w - 1)
                    sym[pos:pos + span] = s
                    nb[pos:pos + span] = max_bits + 1 - w
                    pos += span
        self.max_bits = max_bits
        self.sym, self.nb = sym.tolist(), nb.tolist()

    def decode(self, data: bytes, count: int) -> bytes:
        """`count` symbols of one backward stream, which they must use up."""
        if not data or data[-1] == 0:
            raise ZstdError("a Huffman stream without its end marker")
        rev = data[::-1]
        top, length = rev[0], len(rev)
        n = top.bit_length() - 1
        acc = top & ((1 << n) - 1)
        i, mb = 1, self.max_bits
        mask = (1 << mb) - 1
        sym, nb = self.sym, self.nb
        out = bytearray(count)
        padded = 0
        for k in range(count):
            if n < mb:
                if i < length:
                    chunk = rev[i:i + 7]
                    got = 8 * len(chunk)
                    i += 7
                    acc = ((acc & ((1 << n) - 1)) << got) \
                        | int.from_bytes(chunk, "big")
                    n += got
                if n < mb:                  # past the start: zeros
                    padded += mb - n
                    acc <<= mb - n
                    n = mb
            idx = (acc >> (n - mb)) & mask
            out[k] = sym[idx]
            n -= nb[idx]
        if i < length or n != padded:
            raise ZstdError("a Huffman stream of the wrong length")
        return bytes(out)


def _read_huffman(data: bytes, pos: int) -> Tuple[_Huffman, int]:
    """A Huffman tree description at data[pos:] (RFC 8878 4.2.1.1)."""
    head = data[pos]
    pos += 1
    if head >= 128:                                   # 4-bit weights
        count = head - 127
        raw = data[pos:pos + (count + 1) // 2]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return _Huffman(weights[:count]), pos + (count + 1) // 2
    end = pos + head                                  # FSE-coded weights
    counts, log, start = _read_fse_counts(data[:end], pos, 255, 6)
    table = _Fse(counts, log)
    bits = _BackBits(data[start:end])
    s1, s2 = bits.read(log), bits.read(log)
    weights: List[int] = []
    while True:
        weights.append(table.sym[s1])
        s1 = table.base[s1] + bits.read(table.nb[s1])
        if bits.left < 0:
            weights.append(table.sym[s2])
            break
        weights.append(table.sym[s2])
        s2 = table.base[s2] + bits.read(table.nb[s2])
        if bits.left < 0:
            weights.append(table.sym[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return _Huffman(weights), end


# --------------------------------------------------------------- blocks --

class _FrameState:
    """What a frame's blocks carry from one to the next."""

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables = [None, None, None]              # LL, OF, ML
        self.reps = [1, 4, 8]


def _literals(data: bytes, pos: int, st: _FrameState
              ) -> Tuple[bytes, int]:
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):                                # raw, RLE
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            pos += 3
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("raw literals past the block's end")
            return data[pos:pos + size], pos + size
        return data[pos:pos + 1] * size, pos + 1
    # Huffman-coded (2) or treeless (3)
    nbytes, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    h = int.from_bytes(data[pos:pos + nbytes], "little")
    mask = (1 << bits) - 1
    regen, comp = (h >> 4) & mask, (h >> (4 + bits)) & mask
    pos += nbytes
    end = pos + comp
    if end > len(data):
        raise ZstdError("compressed literals past the block's end")
    if kind == 2:
        st.huffman, pos = _read_huffman(data[:end], pos)
    elif st.huffman is None:
        raise ZstdError("treeless literals with no previous Huffman tree")
    huff = st.huffman
    if fmt == 0:
        return huff.decode(data[pos:end], regen), end
    sizes = struct.unpack("<3H", data[pos:pos + 6])
    pos += 6
    per = (regen + 3) // 4
    out, lo = [], pos
    for k in range(4):
        hi = lo + sizes[k] if k < 3 else end
        if hi > end:
            raise ZstdError("a Huffman stream past the literals' end")
        out.append(huff.decode(data[lo:hi], per if k < 3
                               else regen - 3 * per))
        lo = hi
    return b"".join(out), end


def _table(data: bytes, pos: int, mode: int, which: int, st: _FrameState
           ) -> int:
    default, max_symbol, max_log = ((_LL_DEFAULT, 35, 9),
                                    (_OF_DEFAULT, 31, 8),
                                    (_ML_DEFAULT, 52, 9))[which]
    if mode == 0:
        st.tables[which] = default
    elif mode == 1:
        if data[pos] > max_symbol:
            raise ZstdError("an RLE code past the alphabet")
        st.tables[which] = _Fse.rle(data[pos])
        pos += 1
    elif mode == 2:
        counts, log, pos = _read_fse_counts(data, pos, max_symbol, max_log)
        st.tables[which] = _Fse(counts, log)
    elif st.tables[which] is None:
        raise ZstdError("a repeat table mode with no previous table")
    return pos


def _compressed_block(data: bytes, out: bytearray, st: _FrameState) -> None:
    lits, pos = _literals(data, 0, st)
    b0 = data[pos]
    if b0 == 0:
        nseq, pos = 0, pos + 1
    elif b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        out += lits
        return
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequences' modes")
    for which, shift in ((0, 6), (1, 4), (2, 2)):
        pos = _table(data, pos, (modes >> shift) & 3, which, st)
    ll_t, of_t, ml_t = st.tables
    bits = _BackBits(data[pos:])
    ll_s, of_s, ml_s = bits.read(ll_t.log), bits.read(of_t.log), \
        bits.read(ml_t.log)
    reps = st.reps
    lit_pos = 0
    for k in range(nseq):
        of_code, ll_code, ml_code = (of_t.sym[of_s], ll_t.sym[ll_s],
                                     ml_t.sym[ml_s])
        if of_code > 31:
            raise ZstdError("an offset code past 31")
        ov = (1 << of_code) + bits.read(of_code)
        mb, mx = _ML_CODES[ml_code]
        ml = mb + bits.read(mx)
        lb, lx = _LL_CODES[ll_code]
        ll = lb + bits.read(lx)
        if ov > 3:
            off = ov - 3
            reps[:] = [off, reps[0], reps[1]]
        else:
            idx = ov + (ll == 0)
            if idx == 1:
                off = reps[0]
            elif idx == 2:
                off = reps[1]
                reps[:] = [off, reps[0], reps[2]]
            elif idx == 3:
                off = reps[2]
                reps[:] = [off, reps[0], reps[1]]
            else:
                off = reps[0] - 1
                reps[:] = [off, reps[0], reps[1]]
        if k + 1 < nseq:
            ll_s = ll_t.base[ll_s] + bits.read(ll_t.nb[ll_s])
            ml_s = ml_t.base[ml_s] + bits.read(ml_t.nb[ml_s])
            of_s = of_t.base[of_s] + bits.read(of_t.nb[of_s])
        # execute: ll literals, then ml bytes from off back
        if lit_pos + ll > len(lits):
            raise ZstdError("a sequence past the block's literals")
        out += lits[lit_pos:lit_pos + ll]
        lit_pos += ll
        if off == 0 or off > len(out):
            raise ZstdError(f"a match offset {off} before the window")
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:                                   # overlapping: a repeat
            reps_n, tail = divmod(ml, off)
            piece = out[start:]
            out += piece * reps_n + piece[:tail]
    if bits.left != 0:
        raise ZstdError("a sequences bitstream of the wrong length")
    out += lits[lit_pos:]


# --------------------------------------------------------------- frames --

def _frame(data: bytes, pos: int) -> Tuple[bytes, int]:
    fhd = data[pos]
    pos += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 8:
        raise ZstdError("the frame header's reserved bit is set")
    checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    if not single:
        pos += 1                              # window descriptor
    dict_bytes = (0, 1, 2, 4)[dict_flag]
    dict_id = int.from_bytes(data[pos:pos + dict_bytes], "little")
    pos += dict_bytes
    if dict_id:
        raise ZstdError(f"a frame that needs dictionary {dict_id}")
    fcs_bytes = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size = int.from_bytes(data[pos:pos + fcs_bytes], "little") if \
        fcs_bytes else None
    if fcs_bytes == 2:
        size += 256
    pos += fcs_bytes
    out = bytearray()
    st = _FrameState()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("a truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, bsize = h & 1, (h >> 1) & 3, h >> 3
        if kind == 1:
            out += data[pos:pos + 1] * bsize
            pos += 1
        else:
            if bsize > _BLOCK_MAX or pos + bsize > len(data):
                raise ZstdError("a truncated or oversized block")
            if kind == 0:
                out += data[pos:pos + bsize]
            elif kind == 2:
                _compressed_block(data[pos:pos + bsize], out, st)
            else:
                raise ZstdError("a reserved block type")
            pos += bsize
        if last:
            break
    if size is not None and len(out) != size:
        raise ZstdError(f"a frame of {len(out)} bytes, its header says "
                        f"{size}")
    if checksum:
        want = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ZstdError("the frame's content checksum does not match")
    return bytes(out), pos


def decompress(data: bytes) -> bytes:
    """The content of every frame in `data`, back to back (skippable
    frames give nothing)."""
    data = bytes(data)
    parts, pos = [], 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("trailing bytes after the last frame")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if magic & 0xFFFFFFF0 == 0x184D2A50:          # skippable
            pos += 4 + int.from_bytes(data[pos:pos + 4], "little")
            continue
        if magic != _MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        try:
            out, pos = _frame(data, pos)
        except IndexError as e:
            raise ZstdError("a truncated frame") from e
        parts.append(out)
    if pos != len(data):
        raise ZstdError("a truncated frame")
    return b"".join(parts)


# ---------------------------------------------------------------- XXH64 --

_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the zstd content checksum keeps its low 32 bits)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        stripes = np.frombuffer(data, "<u8", count=(n // 32) * 4).reshape(
            -1, 4).T.tolist()
        for lane in range(4):
            acc = v[lane]
            for x in stripes[lane]:
                acc = (_rotl((acc + x * _P2) & _M64, 31) * _P1) & _M64
            v[lane] = acc
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for acc in v:
            h = ((h ^ _round(0, acc)) * _P1 + _P4) & _M64
        pos = (n // 32) * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        k = _round(0, int.from_bytes(data[pos:pos + 8], "little"))
        h = (_rotl(h ^ k, 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[pos:pos + 4], "little") * _P1)
                   & _M64, 23) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h = (_rotl(h ^ ((data[pos] * _P5) & _M64), 11) * _P1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h
