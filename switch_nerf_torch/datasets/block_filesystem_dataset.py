"""Block-NeRF (Waymo Mission Bay) scenes: GZIP tfrecords -> shuffled chunks.

Port of ``switch_nerf_tpu/datasets/block_filesystem_dataset.py``, with
the records read by ``tfrecord.py`` instead of TensorFlow.
A chunk directory written by either package is reused by the other, and a
``get_state()`` string saved by either restores the other's cursor:

  * each record holds an image (PNG, BGR; flipped to RGB here), its
    per-pixel ray origins and directions, intrinsics, exposure and the
    image hash, and on validation records the moving-object mask (1 ==
    moving == invalid); the hash -> appearance id map comes from a JSON
    file (one map, or one per record file name);
  * mip base radii from the vertical differences of neighbouring ray
    directions times 2 / sqrt(12) (``compute_radii``);
  * training chunks: per image (the left half of a validation image; every
    ``scale_factor``-th pixel, radii scaled by it), a permutation from the
    ``seed`` stream and ``np.array_split`` over ``num_chunks`` chunks whose
    first share rotates from image to image; parts ``rgbs`` uint8,
    ``raydata`` float32 [radii | o | d], ``image_indices`` int16;
    ``manifest.json``, written last, names the records and settings;
  * training: a cyclic chunk iterator with a one-worker prefetch, the chunk
    order from the ``[seed, 1]`` stream (``--shuffle_chunk``), batches of a
    fresh ``[seed, 2]`` permutation per chunk with the last partial batch
    dropped, and ``get_state`` / ``set_state`` for exact resume;
  * ``load_tfrecord``: the eval side's whole images with rays, radii and
    masks.

In a data-parallel run each process keeps rows ``[index::count]`` of every
chunk and draws its share of the global batch from them, the batch count
from the chunk's global row count (``filesystem_dataset.strided_batches``).
Process 0 writes the chunks alone (the cost is the records' decoding,
which every writer would repeat to keep the random stream); the others
wait for its manifest.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from switch_nerf_torch.datasets.dataset_utils import poll_until
from switch_nerf_torch.datasets.filesystem_dataset import (process_share,
                                                           strided_batches)
from switch_nerf_torch.datasets.tfrecord import decode_png, read_examples

_MANIFEST = "manifest.json"

# (feature, kind, scalar): the records' schema; "mask" on validation records
_SCHEMA = (("image_hash", "int64", True), ("cam_idx", "int64", True),
           ("equivalent_exposure", "float", True), ("height", "int64", True),
           ("width", "int64", True), ("image", "bytes", True),
           ("ray_origins", "float", False), ("ray_dirs", "float", False),
           ("intrinsics", "float", False))


def compute_radii(rays_d: np.ndarray) -> np.ndarray:
    """rays_d [H, W, 3] -> mip base radii [H, W, 1]."""
    dx = np.sqrt(np.sum((rays_d[:-1, :, :] - rays_d[1:, :, :]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1, :]], 0)
    return dx[..., None] * 2.0 / np.sqrt(12.0)


def _feature(example: dict, name: str, kind: str, scalar: bool, path):
    if name not in example:
        raise ValueError(f"{path}: record lacks feature {name!r}")
    got, values = example[name]
    if got != kind and not (len(values) == 0 and not scalar):
        raise ValueError(f"{path}: feature {name!r} is {got}, not {kind}")
    if scalar:
        if len(values) != 1:
            raise ValueError(f"{path}: feature {name!r} has {len(values)} "
                             "values, not 1")
        return values[0]
    return values


def handle_one_record(tfrecord, hash_id_map: Dict[str, int],
                      load_mask: bool = False) -> List[Dict]:
    """Decode every image in one GZIP tfrecord file."""
    schema = _SCHEMA + ((("mask", "int64", False),) if load_mask else ())
    out = []
    for ex in read_examples(tfrecord):
        f = {name: _feature(ex, name, kind, scalar, tfrecord)
             for name, kind, scalar in schema}
        image_hash = str(int(f["image_hash"]))
        # records store BGR; flip to RGB
        image = decode_png(f["image"])[..., ::-1].copy()
        h, w = int(f["height"]), int(f["width"])
        d = {
            "image_hash": image_hash,
            "cam_idx": int(f["cam_idx"]),
            "equivalent_exposure": float(f["equivalent_exposure"]),
            "height": h,
            "width": w,
            "intrinsics": np.asarray(f["intrinsics"], np.float32),
            "image": image.astype(np.uint8),
            "ray_origins": np.asarray(f["ray_origins"],
                                      np.float32).reshape(h, w, 3),
            "ray_dirs": np.asarray(f["ray_dirs"],
                                   np.float32).reshape(h, w, 3),
            "image_ids": int(hash_id_map[image_hash]),
        }
        if load_mask:
            d["mask"] = np.asarray(f["mask"]).reshape(h, w, 1).astype(
                np.float32)
        out.append(d)
    return out


def load_tfrecord(tfrecord_path, hash_id_map, near: float, far: float,
                  load_mask: bool = False) -> List[Dict]:
    """Eval-side loader: full images + rays + radii (+masks)."""
    dicts = handle_one_record(tfrecord_path, hash_id_map=hash_id_map,
                              load_mask=load_mask)
    for d in dicts:
        rgbs = d["image"].astype(np.float32) / 255.0
        o, dirs = d["ray_origins"], d["ray_dirs"]
        radii = compute_radii(dirs)
        nf = np.full((*o.shape[:-1], 1), near, np.float32)
        ff = np.full((*o.shape[:-1], 1), far, np.float32)
        d["rgbs"] = rgbs
        d["rays"] = np.concatenate([o, dirs, nf, ff], -1).astype(np.float32)
        d["radii"] = radii.astype(np.float32)
        d["image_indices"] = np.full(o.shape[:2], d["image_ids"], np.int16)
    return dicts


def record_id_map(id_map: dict, record) -> dict:
    """The hash -> id map of one record file: its own entry of a per-file
    map, else the one map."""
    name = os.path.basename(str(record))
    return id_map[name] if name in id_map else id_map


class BlockFilesystemDataset:
    """tfrecords -> shuffled npz chunk parts; chunk rows are [radii(1) |
    o(3) | d(3)] + rgbs + image ids, near/far appended at load."""

    def __init__(self, data_path, near: float, far: float, scale_factor: int,
                 list_path, id_map_path, chunk_paths: Sequence[Path],
                 num_chunks: int, disk_flush_size: int,
                 shuffle_chunk: bool = False, seed: int = 42,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self._process_index, self._process_count = process_share(
            process_index, process_count)
        self._global_rows = 0
        self._near, self._far = float(near), float(far)
        # decoupled streams: chunk contents, chunk order, batch order
        self._rng = np.random.default_rng(seed)
        self._order_rng = np.random.default_rng([seed, 1])
        self._batch_rng = np.random.default_rng([seed, 2])
        self._batch_rng_pre_draw = self._batch_rng.bit_generator.state

        self._tfrecord_paths = self._get_tfrecord_paths(data_path, list_path)
        with open(id_map_path) as f:
            self._image_hash_id_map = json.load(f)

        root = Path(sorted(str(p) for p in chunk_paths)[0])
        manifest = {"records": [os.path.basename(str(p))
                                for p in self._tfrecord_paths],
                    "num_chunks": num_chunks, "near": self._near,
                    "far": self._far, "scale_factor": scale_factor}
        mf = root / _MANIFEST
        if not mf.exists() and self._process_index != 0:
            poll_until(lambda: mf.exists() or None, interval_s=0.2)
        if mf.exists():
            if json.loads(mf.read_text()) != manifest:
                raise ValueError(f"chunk dir {root} written with different "
                                 "settings; delete it or change chunk_paths")
        else:
            root.mkdir(parents=True, exist_ok=True)
            self._write_chunks(root, num_chunks, disk_flush_size,
                               scale_factor)
            mf.write_text(json.dumps(manifest))

        self._chunk_paths = sorted(
            p for p in root.iterdir()
            if p.is_dir() and p.name.startswith("chunk_"))
        if shuffle_chunk:
            order = self._order_rng.permutation(len(self._chunk_paths))
            self._chunk_paths = [self._chunk_paths[i] for i in order]

        self._chunk_index = 0
        self._loaded_index = 0
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._loaded: Optional[Dict[str, np.ndarray]] = None
        self._next: Optional[Future] = None
        self._start_prefetch()

    @staticmethod
    def _get_tfrecord_paths(data_path, list_path) -> List[Path]:
        names = [ln.strip() for ln in Path(list_path).read_text().splitlines()
                 if ln.strip()]
        return [Path(data_path) / n for n in names]

    def close(self) -> None:
        """Stop the prefetch worker (a queued load is cancelled)."""
        self._executor.shutdown(wait=True, cancel_futures=True)

    # ------------------------------------------------------------- state --
    def get_state(self) -> str:
        """The resume cursor, as JSON: the loaded chunk and the batch
        stream's state from before that chunk's permutation."""
        return json.dumps({"chunk": self._loaded_index,
                           "batch_rng": self._batch_rng_pre_draw})

    def set_state(self, state: str) -> None:
        """Restore a ``get_state()`` string (or a plain chunk index) and
        restart the prefetch at that chunk."""
        try:
            st = json.loads(state)
        except (json.JSONDecodeError, TypeError):
            st = {"chunk": int(state)}
        if isinstance(st, int):
            st = {"chunk": st}
        self._chunk_index = int(st["chunk"]) % len(self._chunk_paths)
        if st.get("batch_rng") is not None:
            self._batch_rng.bit_generator.state = st["batch_rng"]
            self._batch_rng_pre_draw = st["batch_rng"]
        if self._next is not None:
            self._next.cancel()
        self._start_prefetch()

    # ----------------------------------------------------------- loading --
    def _start_prefetch(self) -> None:
        path = self._chunk_paths[self._chunk_index]
        self._next = self._executor.submit(self._read_chunk, path)

    def load_chunk(self) -> None:
        """Wait for the prefetched chunk, make it current, start the next."""
        self._loaded = self._next.result()
        self._global_rows = self._loaded.pop("_n_global")
        self._loaded_index = self._chunk_index
        self._chunk_index = (self._chunk_index + 1) % len(self._chunk_paths)
        self._start_prefetch()

    def _read_chunk(self, path: Path) -> Dict[str, np.ndarray]:
        arrays: Dict[str, List[np.ndarray]] = {}
        for p in sorted(path.glob("part_*.npz")):
            with np.load(p) as z:
                for k in z.files:
                    arrays.setdefault(k, []).append(z[k])
        out = {k: np.concatenate(v) for k, v in arrays.items()}
        n_global = out["rgbs"].shape[0]
        if self._process_count > 1:
            sl = slice(self._process_index, None, self._process_count)
            out = {k: v[sl] for k, v in out.items()}
        raydata = out["raydata"].astype(np.float32)     # [N, 7] radii|o|d
        n = raydata.shape[0]
        nf = np.full((n, 1), self._near, np.float32)
        ff = np.full((n, 1), self._far, np.float32)
        return {
            "rgbs": out["rgbs"].astype(np.float32) / 255.0,
            "rays": np.concatenate([raydata[:, 1:7], nf, ff], -1),
            "radii": raydata[:, 0:1],
            "image_indices": out["image_indices"].astype(np.float32),
            "_n_global": n_global,
        }

    # ------------------------------------------------------------ access --
    def __len__(self) -> int:
        if self._loaded is None:
            raise RuntimeError("call load_chunk() first")
        return self._loaded["rgbs"].shape[0]

    def sample_batches(self, batch_size: int
                       ) -> Iterator[Dict[str, np.ndarray]]:
        """The loaded chunk's rows (this process's share of them) in
        batches of a fresh permutation, the last partial batch dropped;
        ``strided_batches``."""
        if self._loaded is None:
            raise RuntimeError("call load_chunk() first")
        self._batch_rng_pre_draw = self._batch_rng.bit_generator.state
        return strided_batches(self._loaded, self._batch_rng, batch_size,
                               self._global_rows, self._process_count)

    # ----------------------------------------------------------- writing --
    def _write_chunks(self, chunk_dir: Path, num_chunks: int,
                      disk_flush_size: int, scale_factor: int) -> None:
        # without a manifest, chunk dirs are leftovers of an interrupted
        # write: _read_chunk would concatenate their stale parts
        for stale in chunk_dir.glob("chunk_*"):
            shutil.rmtree(stale)
        for i in range(num_chunks):
            (chunk_dir / f"chunk_{i:04d}").mkdir(exist_ok=True)
        buffers: List[Dict[str, List[np.ndarray]]] = [
            {} for _ in range(num_chunks)]
        part_ids = [0] * num_chunks
        pending: List[Future] = []
        buffered = 0

        with ThreadPoolExecutor(max_workers=10) as pool:
            def flush(cid: int) -> None:
                nonlocal buffered
                buf = buffers[cid]
                if not buf:
                    return
                arrays = {k: np.concatenate(v) for k, v in buf.items()}
                path = (chunk_dir / f"chunk_{cid:04d}"
                        / f"part_{part_ids[cid]:04d}.npz")
                part_ids[cid] += 1
                buffered -= arrays["rgbs"].shape[0]
                buffers[cid] = {}
                pending.append(pool.submit(np.savez, path, **arrays))

            next_chunk = 0
            for rec in self._tfrecord_paths:
                dicts = handle_one_record(
                    rec, hash_id_map=record_id_map(self._image_hash_id_map,
                                                   rec))
                is_val = "validation" in str(rec)
                for d in dicts:
                    w = d["width"]
                    img, o, dirs = d["image"], d["ray_origins"], d["ray_dirs"]
                    radii = compute_radii(dirs)
                    if is_val:         # validation trains on the left half
                        img, o = img[:, :w // 2], o[:, :w // 2]
                        dirs, radii = dirs[:, :w // 2], radii[:, :w // 2]
                    if scale_factor > 1:
                        s = scale_factor
                        img, o, dirs = img[::s, ::s], o[::s, ::s], \
                            dirs[::s, ::s]
                        # a kept pixel spans s full-resolution pixels
                        radii = radii[::s, ::s] * float(s)
                    rgbs = img.reshape(-1, 3)
                    raydata = np.concatenate(
                        [radii.reshape(-1, 1), o.reshape(-1, 3),
                         dirs.reshape(-1, 3)], -1).astype(np.float32)
                    ids = np.full((rgbs.shape[0],), d["image_ids"], np.int16)

                    n = rgbs.shape[0]
                    perm = self._rng.permutation(n)
                    cols = {"rgbs": rgbs[perm], "raydata": raydata[perm],
                            "image_indices": ids}
                    for j, sl in enumerate(np.array_split(np.arange(n),
                                                          num_chunks)):
                        if sl.size == 0:
                            continue
                        cid = (next_chunk + j) % num_chunks
                        for k, v in cols.items():
                            buffers[cid].setdefault(k, []).append(v[sl])
                    next_chunk = (next_chunk + 1) % num_chunks
                    buffered += n
                    if buffered >= disk_flush_size:
                        for cid in range(num_chunks):
                            flush(cid)
            for cid in range(num_chunks):
                flush(cid)
            for f in pending:
                f.result()
