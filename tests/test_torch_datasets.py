"""The port's training datasets (datasets/dataset_utils.py,
memory_dataset.py, filesystem_dataset.py) vs the JAX package's, on the CPU.

The same synthetic Mega-NeRF scene (4 train + 1 val 24x16 images, one
train image and the val image with a keep mask) goes through both
packages from the same seed. The JAX package runs on its numpy path
(``switch_nerf_tpu.native.get_lib`` patched to return None), as the port
does. Tolerances: everything drawn or stored is equal (pixel selections,
permutations, chunk arrays, manifests, generator states, cursor strings);
rays to 1e-6.
"""
import io
import json
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from switch_nerf_tpu import native
from switch_nerf_tpu.datasets import dataset_utils as jdu
from switch_nerf_tpu.datasets import filesystem_dataset as jfs
from switch_nerf_tpu.datasets import image_metadata as jim
from switch_nerf_tpu.datasets import memory_dataset as jmem
from switch_nerf_torch.datasets import dataset_utils as tdu
from switch_nerf_torch.datasets import filesystem_dataset as tfs
from switch_nerf_torch.datasets import image_metadata as tim
from switch_nerf_torch.datasets import memory_dataset as tmem

W, H = 24, 16
NEAR, FAR, ALT = 0.05, 1e5, [-3.0, 0.5]


@pytest.fixture(autouse=True)
def numpy_rays(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)


def write_mask(path: Path, mask: np.ndarray) -> Path:
    """A Mega-NeRF keep mask: a torch-saved bool tensor in a zip."""
    buf = io.BytesIO()
    torch.save(torch.from_numpy(mask), buf)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr(path.name, buf.getvalue())
    return path


@pytest.fixture(scope="module", params=["shared", "per_image"])
def scene(request, tmp_path_factory):
    """(root, records): per image (rgb path, c2w, intrinsics, index, mask
    path, is_val). "per_image" gives image 2 other intrinsics, so chunks
    store rays instead of pixel indices."""
    root = tmp_path_factory.mktemp(f"scene_{request.param}")
    rng = np.random.default_rng(0)
    records = []
    for i in range(5):
        c2w = np.eye(3, 4, dtype=np.float32)
        c2w[:, 3] = rng.normal(0, 0.1, 3)
        c2w[0, 3] -= 0.5
        focal = 22.0 if (request.param == "per_image" and i == 2) else 20.0
        intr = np.array([focal, focal, W / 2, H / 2], np.float32)
        img = root / f"{i:03d}.jpg"
        Image.fromarray(rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)
                        ).save(img)
        mask = None
        if i in (1, 4):
            mask = write_mask(root / f"{i:03d}.pt",
                              rng.uniform(size=(H, W)) < 0.7)
        records.append((img, c2w, intr, i, mask, i == 4))
    return root, records


def items(records, module):
    return [module.ImageMetadata(img, c2w, W, H, intr, idx, mask, val)
            for img, c2w, intr, idx, mask, val in records]


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "rays":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("masked", [True, False])
def test_rgb_index_mask_matches_jax(scene, masked):
    """A val image with and without a keep mask: rgbs, indices and mask
    equal, and both generators left in the same state."""
    _, records = scene
    img, c2w, intr, idx, mask, _ = records[4]
    mask = mask if masked else None
    got_rng, want_rng = np.random.default_rng(3), np.random.default_rng(3)
    got = tdu.get_rgb_index_mask(
        tim.ImageMetadata(img, c2w, W, H, intr, idx, mask, True), got_rng)
    want = jdu.get_rgb_index_mask(
        jim.ImageMetadata(img, c2w, W, H, intr, idx, mask, True), want_rng)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert not got[2].reshape(H, W)[:, W // 2:].any()
    assert got_rng.bit_generator.state == want_rng.bit_generator.state


def test_epoch_sampler_matches_jax():
    got, want = tdu.EpochPermutationSampler(100, 7), \
        jdu.EpochPermutationSampler(100, 7)
    for b in (0, 3, 4, 5, 11, 2):            # 4 batches an epoch
        np.testing.assert_array_equal(got.batch_indices(b, 24),
                                      want.batch_indices(b, 24))
    tiny = tdu.EpochPermutationSampler(10, 1)
    np.testing.assert_array_equal(
        tiny.batch_indices(3, 16),
        jdu.EpochPermutationSampler(10, 1).batch_indices(3, 16))


def test_memory_dataset_matches_jax(scene):
    _, records = scene
    got = tmem.MemoryDataset(items(records, tim), NEAR, FAR, ALT, True,
                             seed=5)
    want = jmem.MemoryDataset(items(records, jim), NEAR, FAR, ALT, True,
                              seed=5)
    assert len(got) == len(want)
    for b in (0, 1, 7, 30):
        assert_batches_equal(got.get_batch(b, 64), want.get_batch(b, 64))


def fs_args(records, module, chunk_dir, seed=4):
    return (items(records, module), NEAR, FAR, ALT, True, [chunk_dir], 3, 1,
            500), dict(shuffle_chunk=True, seed=seed)


def chunk_arrays(chunk_dir: Path):
    out = {}
    for part in sorted(chunk_dir.glob("chunk_*/part_*.npz")):
        with np.load(part) as z:
            out[str(part.relative_to(chunk_dir))] = {k: z[k] for k in z.files}
    return out


def next_batches(ds, n_chunks, batch_size=64):
    out = []
    for _ in range(n_chunks):
        ds.load_chunk()
        out += list(ds.sample_batches(batch_size))
    return out


def test_filesystem_chunks_match_jax(scene, tmp_path):
    """Both packages write a chunk directory from the same seed: equal
    manifests, equal arrays in every part, equal batches over two chunks
    (the chunk order shuffled by the [seed, 1] stream)."""
    _, records = scene
    args, kw = fs_args(records, tim, tmp_path / "t")
    got = tfs.FilesystemDataset(*args, **kw)
    args, kw = fs_args(records, jim, tmp_path / "j")
    want = jfs.FilesystemDataset(*args, **kw)
    try:
        assert json.loads((tmp_path / "t" / "manifest.json").read_text()) \
            == json.loads((tmp_path / "j" / "manifest.json").read_text())
        ta, ja = chunk_arrays(tmp_path / "t"), chunk_arrays(tmp_path / "j")
        assert sorted(ta) == sorted(ja) and len(ta) > 3   # several flushes
        for part, arrays in ja.items():
            assert list(ta[part]) == list(arrays)
            for k, v in arrays.items():
                np.testing.assert_array_equal(ta[part][k], v, err_msg=part)
                assert ta[part][k].dtype == v.dtype
        shared = "pixel_indices" in next(iter(ja.values()))
        assert shared == (records[2][2][0] == records[0][2][0])
        tb, jb = next_batches(got, 2), next_batches(want, 2)
        assert len(tb) == len(jb) > 4
        for a, b in zip(tb, jb):
            assert_batches_equal(a, b)
        assert got.get_state() == want.get_state()
    finally:
        got.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_filesystem_reuse_and_state_cross(scene, tmp_path, writer):
    """A chunk directory written by one package is reused by the other
    (not rewritten), and a get_state() string of one restores the other's
    cursor: the same next batches."""
    _, records = scene
    chunks = tmp_path / "chunks"
    mods = {"jax": (jfs, jim), "port": (tfs, tim)}
    (wfs, wim), (rfs, rim) = mods[writer], mods[
        "port" if writer == "jax" else "jax"]
    args, kw = fs_args(records, wim, chunks)
    first = wfs.FilesystemDataset(*args, **kw)
    stamps = {p: p.stat().st_mtime_ns for p in chunks.rglob("*")}
    next_batches(first, 1)
    first.load_chunk()                          # into the second chunk
    batches = first.sample_batches(64)
    next(batches)
    cursor = first.get_state()
    want = list(batches)

    args, kw = fs_args(records, rim, chunks)
    second = rfs.FilesystemDataset(*args, **kw)
    try:
        assert {p: p.stat().st_mtime_ns for p in chunks.rglob("*")} == stamps
        second.set_state(cursor)
        second.load_chunk()
        got = list(second.sample_batches(64))[1:]
        assert second.get_state() == cursor
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert_batches_equal(a, b)
    finally:
        for ds in (first, second):
            if hasattr(ds, "close"):
                ds.close()
    # the legacy cursor (a plain chunk index) is accepted too
    args, kw = fs_args(records, tim, chunks)
    legacy = tfs.FilesystemDataset(*args, **kw)
    try:
        legacy.set_state("1")
        legacy.load_chunk()
        assert json.loads(legacy.get_state())["chunk"] == 1
    finally:
        legacy.close()


def test_filesystem_refusals(scene, tmp_path):
    _, records = scene
    args, kw = fs_args(records, tim, tmp_path / "c")
    tfs.FilesystemDataset(*args, **kw).close()
    args = list(args)
    args[6] = 4                                  # another num_chunks
    with pytest.raises(ValueError, match="different settings"):
        tfs.FilesystemDataset(*args, **kw)
    # an interrupted write (no manifest) is redone from scratch
    (tmp_path / "c" / "manifest.json").unlink()
    (tmp_path / "c" / "chunk_0009").mkdir()
    args[6] = 3
    tfs.FilesystemDataset(*args, **kw).close()
    assert not (tmp_path / "c" / "chunk_0009").exists()
    fresh = tfs.FilesystemDataset(*args, **kw)
    try:
        with pytest.raises(RuntimeError, match="load_chunk"):
            len(fresh)
    finally:
        fresh.close()
