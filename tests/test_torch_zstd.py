"""The port's zstd decoder (switch_nerf_torch/utils/zstd.py) against the
``zstandard`` package (a test-only import; the card's machine has none).

One case per input family, each compressed at levels 1, 3 and 19, one-shot
(content size in the header) and streamed (a window descriptor, no
content size) with and without the XXH64 content checksum: random fp32
and bf16 bytes (Huffman literals), zeros (RLE), text (FSE sequences and
repeat offsets), inputs of several 128 KiB blocks (raw, compressed and
treeless blocks, tables carried from block to block), and every zstd
frame of an orbax checkpoint written here (its OCDBT nodes and zarr
chunks). Corrupt frames and dictionaries raise.
"""
import numpy as np
import pytest

from switch_nerf_torch.utils import zstd as Z

zstandard = pytest.importorskip("zstandard")

LEVELS = (1, 3, 19)


def _inputs(family: str):
    rng = np.random.default_rng(7)
    if family == "fp32":
        return [rng.standard_normal(20000).astype(np.float32).tobytes()]
    if family == "bf16":
        bits = rng.standard_normal(30000).astype(np.float32).view(np.uint32)
        return [(bits >> 16).astype(np.uint16).tobytes()]
    if family == "zeros":
        return [bytes(70000), b"\x07" * 3000, b"", b"a"]
    if family == "text":
        return [b"".join(b"ray %d hits expert %d at depth %.3f; " % (
            i, i % 8, i / 7.0) for i in range(3000))]
    if family == "multiblock":
        text = b"".join(b"chunk %05d of the grid " % i for i in range(12000))
        noise = rng.integers(0, 256, 140000, dtype=np.uint8).tobytes()
        small = rng.integers(0, 5, 150000, dtype=np.uint8).tobytes()
        floats = rng.standard_normal(40000).astype(np.float32).tobytes()
        return [text + noise + small + floats]
    raise KeyError(family)


def _frames(data: bytes, level: int):
    """One-shot, streamed, and streamed with a checksum."""
    yield zstandard.ZstdCompressor(level=level).compress(data)
    for checksum in (False, True):
        c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=False).compressobj()
        yield c.compress(data) + c.flush()


@pytest.mark.parametrize("family", ["fp32", "bf16", "zeros", "text",
                                    "multiblock"])
def test_decodes_what_zstandard_writes(family):
    for data in _inputs(family):
        for level in LEVELS:
            for frame in _frames(data, level):
                assert Z.decompress(frame) == data, (family, level)
    # frames back to back and a skippable frame between them
    data = _inputs(family)[0]
    c = zstandard.ZstdCompressor(level=3)
    skip = (0x184D2A50).to_bytes(4, "little") + (3).to_bytes(4, "little") \
        + b"xyz"
    assert Z.decompress(c.compress(data) + skip + c.compress(data[:100])) \
        == data + data[:100]


def test_every_frame_of_an_orbax_checkpoint(tmp_path):
    """Every OCDBT manifest and node body, and every zarr chunk value of a
    JAX orbax checkpoint, as zstandard decodes it."""
    import json

    import tensorstore as ts
    from tests.make_orbax_fixture import fixture_hparams, write_pair

    root = write_pair(tmp_path / "pair", fixture_hparams())["orbax"] / "orbax"
    d = zstandard.ZstdDecompressor()
    n = 0
    for path in [p for p in root.rglob("*") if p.is_file()]:
        raw = path.read_bytes()
        if raw[:4] in (bytes.fromhex("0cdb3a2a"), bytes.fromhex("0cdb20de")):
            body = raw[14:-4]
            assert Z.decompress(body) == d.decompressobj().decompress(body)
            n += 1
    store = ts.KvStore.open(f"file://{root}/|ocdbt:").result()
    for key in store.list().result():
        value = store[key]
        if key.endswith(b".zarray"):
            assert json.loads(value)["compressor"]["id"] == "zstd"
            continue
        assert Z.decompress(value) == d.decompressobj().decompress(value)
        n += 1
    assert n > 50


def test_xxh64_and_refusals():
    # XXH64 reference values (xxhash's test vectors, seed 0)
    assert Z.xxh64(b"") == 0xEF46DB3751D8E999
    assert Z.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert Z.xxh64(b"abc") == 0x44BC2CF5AD770999
    data = b"".join(b"%d," % i for i in range(5000))
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(data))
    frame[-1] ^= 1
    with pytest.raises(Z.ZstdError, match="checksum"):
        Z.decompress(bytes(frame))
    good = zstandard.ZstdCompressor(level=3).compress(data)
    with pytest.raises(Z.ZstdError):
        Z.decompress(good[:len(good) // 2])
    with pytest.raises(Z.ZstdError, match="not a zstd frame"):
        Z.decompress(b"\x00" * 16)
    # a frame that names a dictionary (id 5): the header's dictionary flag
    # set to one byte, after the window descriptor
    with_dict = good[:4] + bytes([0x01, 0x00, 0x05]) + good[6:]
    with pytest.raises(Z.ZstdError, match="dictionary 5"):
        Z.decompress(with_dict)
