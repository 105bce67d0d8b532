"""Chunked disk-shuffle dataset for Mega-NeRF-scale scenes, one process.

Port of ``switch_nerf_tpu/datasets/filesystem_dataset.py``. A chunk
directory written by either package is reused by the other, and a
``get_state()`` string saved by either restores the other's cursor:

  * chunk writing: per image, the kept pixels (``get_rgb_index_mask``), a
    permutation, and a round-robin split over ``num_chunks`` chunks whose
    first share rotates from image to image; buffers are flushed to disk by
    a thread pool once ``disk_flush_size`` rows are held;
  * the on-disk format: ``chunk_NNNN/part_NNNN.npz`` with ``rgbs`` uint8,
    ``image_indices`` int16, and ``pixel_indices`` int64 when every image
    shares one set of intrinsics (rays are rebuilt at load time), else
    ``rays`` float32; ``manifest.json`` (settings + a digest of every
    image's path, pose and intrinsics), written last, marks the directory
    complete and valid for reuse;
  * three decoupled numpy streams: ``seed`` draws the chunk contents,
    ``[seed, 1]`` the chunk order (``--shuffle_chunk``), ``[seed, 2]`` the
    batch order within each chunk;
  * training: a cyclic chunk iterator with a one-worker prefetch, batches
    of one chunk in a fresh permutation with the last partial batch
    dropped, and ``get_state`` / ``set_state`` for exact resume.

Rays are rebuilt with numpy (``ray_utils``), with fancy indexing for the
row gathers. The JAX package's host C++ ray generator
(``switch_nerf_tpu/native/raygen.cc``) is not ported: it is no TPU kernel,
it speeds up work that runs in the prefetch thread, and the JAX package's
own numpy fallback gives the same rays within 1e-5.

Process striding and the cooperative multi-writer chunk generation wait
for the port's multi-process support (ROADMAP Queue A item 8): a
``torch.distributed`` group of more than one process raises.
"""
from __future__ import annotations

import hashlib
import json
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from switch_nerf_torch.datasets.dataset_utils import get_rgb_index_mask
from switch_nerf_torch.datasets.image_metadata import ImageMetadata
from switch_nerf_torch.datasets.ray_utils import (_get_rays_inner,
                                                  compute_image_rays,
                                                  get_ray_directions)

_MANIFEST = "manifest.json"


def _check_one_process() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "a FilesystemDataset shared by several processes waits for the "
            "port's multi-process support (ROADMAP Queue A item 8)")


class FilesystemDataset:
    def __init__(self, metadata_items: List[ImageMetadata], near: float,
                 far: float, ray_altitude_range: Optional[Sequence[float]],
                 center_pixels: bool, chunk_paths: Sequence[Path],
                 num_chunks: int, scale_factor: int, disk_flush_size: int,
                 shuffle_chunk: bool = False, seed: int = 42):
        _check_one_process()
        self._near = float(near)
        self._far = float(far)
        self._ray_altitude_range = (list(ray_altitude_range)
                                    if ray_altitude_range is not None else None)
        self._center_pixels = bool(center_pixels)
        self._rng = np.random.default_rng(seed)
        self._order_rng = np.random.default_rng([seed, 1])
        self._batch_rng = np.random.default_rng([seed, 2])
        self._batch_rng_pre_draw = self._batch_rng.bit_generator.state

        # one shared intrinsics set: store pixel indices instead of rays
        intrinsics = {tuple(np.round(m.intrinsics, 6)) + (m.W, m.H)
                      for m in metadata_items}
        self._shared_intrinsics = len(intrinsics) == 1
        self._metadata_items = metadata_items

        chunk_dir = self._existing_chunk_dir(chunk_paths, num_chunks,
                                             scale_factor)
        if chunk_dir is None:
            chunk_dir = Path(sorted(Path(p) for p in chunk_paths)[0])
            chunk_dir.mkdir(parents=True, exist_ok=True)
            self._write_chunks(chunk_dir, num_chunks, scale_factor,
                               disk_flush_size)

        self._chunk_paths = sorted(
            p for p in chunk_dir.iterdir()
            if p.is_dir() and p.name.startswith("chunk_"))
        if shuffle_chunk:
            order = self._order_rng.permutation(len(self._chunk_paths))
            self._chunk_paths = [self._chunk_paths[i] for i in order]

        self._chunk_index = 0
        self._loaded_index = 0
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._next_chunk: Optional[Future] = None
        self._loaded: Optional[Dict[str, np.ndarray]] = None
        self._start_prefetch()

    def close(self) -> None:
        """Stop the prefetch worker (a queued load is cancelled)."""
        self._executor.shutdown(wait=True, cancel_futures=True)

    # ------------------------------------------------------------- state --
    def get_state(self) -> str:
        """The resume cursor, as JSON: the loaded chunk (the one the
        checkpoint's dataset_index counts into, not the prefetched one) and
        the batch stream's state from before that chunk's permutation, so a
        resumed run draws the same batch order and the dataset_index
        fast-forward skips exactly the rows already trained."""
        return json.dumps({"chunk": self._loaded_index,
                           "batch_rng": self._batch_rng_pre_draw})

    def set_state(self, state: str) -> None:
        """Restore a ``get_state()`` string (or the legacy plain chunk
        index) and restart the prefetch at that chunk."""
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
        if self._next_chunk is not None:
            self._next_chunk.cancel()
        self._start_prefetch()

    # ----------------------------------------------------------- loading --
    def _start_prefetch(self) -> None:
        path = self._chunk_paths[self._chunk_index]
        self._next_chunk = self._executor.submit(self._read_chunk, path)

    def load_chunk(self) -> None:
        """Wait for the prefetched chunk, make it current, start the next."""
        self._loaded = self._next_chunk.result()
        self._loaded_index = self._chunk_index
        self._chunk_index = (self._chunk_index + 1) % len(self._chunk_paths)
        self._start_prefetch()

    def _read_chunk(self, path: Path) -> Dict[str, np.ndarray]:
        arrays: Dict[str, List[np.ndarray]] = {}
        for part in sorted(path.glob("part_*.npz")):
            with np.load(part) as z:
                for k in z.files:
                    arrays.setdefault(k, []).append(z[k])
        out = {k: np.concatenate(v) for k, v in arrays.items()}
        if "rays" in out:
            rays = out["rays"].astype(np.float32)
        else:
            rays = self._reconstruct_rays(out["pixel_indices"],
                                          out["image_indices"])
        return {"rgbs": out["rgbs"].astype(np.float32) / 255.0,
                "rays": rays,
                "image_indices": out["image_indices"].astype(np.float32)}

    def _reconstruct_rays(self, pixel_indices: np.ndarray,
                          image_indices: np.ndarray) -> np.ndarray:
        """Rays [N, 8] of the stored (pixel, image) pairs under the shared
        intrinsics."""
        m0 = self._metadata_items[0]
        directions = get_ray_directions(
            m0.W, m0.H, m0.intrinsics[0], m0.intrinsics[1], m0.intrinsics[2],
            m0.intrinsics[3], self._center_pixels).reshape(-1, 3)
        c2ws = np.stack([m.c2w for m in self._metadata_items])
        dirs = directions[pixel_indices]                             # [N, 3]
        c2w = c2ws[image_indices.astype(np.int64)]                   # [N,3,4]
        rays_d = np.einsum("nij,nj->ni", c2w[:, :, :3], dirs)
        rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
        rays_o = c2w[:, :, 3].copy()
        return _get_rays_inner(rays_o, rays_d, self._near, self._far,
                               self._ray_altitude_range)

    # ------------------------------------------------------------ access --
    def __len__(self) -> int:
        if self._loaded is None:
            raise RuntimeError("call load_chunk() first")
        return self._loaded["rgbs"].shape[0]

    def sample_batches(self, batch_size: int
                       ) -> Iterator[Dict[str, np.ndarray]]:
        """The loaded chunk's rows in batches of a fresh permutation, the
        last partial batch dropped."""
        n = len(self)
        self._batch_rng_pre_draw = self._batch_rng.bit_generator.state
        order = self._batch_rng.permutation(n)
        for i in range(0, n - n % batch_size, batch_size):
            idx = order[i:i + batch_size]
            yield {k: v[idx] for k, v in self._loaded.items()}

    # ----------------------------------------------------------- writing --
    def _manifest(self, num_chunks: int, scale_factor: int) -> Dict:
        items = self._metadata_items
        return {
            "images": len(items),
            "num_chunks": num_chunks,
            "scale_factor": scale_factor,
            "near": self._near,
            "far": self._far,
            "ray_altitude_range": (
                None if self._ray_altitude_range is None
                else [float(x) for x in self._ray_altitude_range]),
            "center_pixels": self._center_pixels,
            "shared_intrinsics": self._shared_intrinsics,
            "paths": [str(m.image_path) for m in items[:16]],
            # every image's path, pose and intrinsics: new camera poses for
            # the same files must invalidate the chunks
            "digest": self._items_digest(items),
        }

    @staticmethod
    def _items_digest(metadata_items) -> str:
        h = hashlib.sha1()
        for m in metadata_items:
            h.update(str(m.image_path).encode())
            h.update(np.ascontiguousarray(m.c2w, np.float32).tobytes())
            h.update(np.ascontiguousarray(m.intrinsics, np.float32).tobytes())
            h.update(np.int64(m.W).tobytes() + np.int64(m.H).tobytes())
        return h.hexdigest()

    def _existing_chunk_dir(self, chunk_paths, num_chunks: int,
                            scale_factor: int) -> Optional[Path]:
        wanted = self._manifest(num_chunks, scale_factor)
        for cp in sorted(Path(p) for p in chunk_paths):
            mf = cp / _MANIFEST
            if mf.exists():
                if json.loads(mf.read_text()) == wanted:
                    return cp
                raise ValueError(
                    f"chunk dir {cp} was written with different settings; "
                    "delete it or point --chunk_paths elsewhere")
        return None

    def _write_chunks(self, chunk_dir: Path, num_chunks: int,
                      scale_factor: int, disk_flush_size: int) -> None:
        # without a manifest, chunk dirs are leftovers of an interrupted
        # write: _read_chunk would concatenate their stale parts
        for stale in chunk_dir.glob("chunk_*"):
            shutil.rmtree(stale)
        for i in range(num_chunks):
            (chunk_dir / f"chunk_{i:04d}").mkdir()
        buffers: List[Dict[str, List[np.ndarray]]] = [
            {} for _ in range(num_chunks)]
        part_ids = [0] * num_chunks
        pending: List[Future] = []
        buffered = 0

        with ThreadPoolExecutor(max_workers=10) as pool:
            def flush(cid: int) -> None:
                nonlocal buffered
                if not buffers[cid]:
                    return
                arrays = {k: np.concatenate(v)
                          for k, v in buffers[cid].items()}
                path = (chunk_dir / f"chunk_{cid:04d}"
                        / f"part_{part_ids[cid]:04d}.npz")
                part_ids[cid] += 1
                buffered -= arrays["rgbs"].shape[0]
                buffers[cid] = {}
                pending.append(pool.submit(np.savez, path, **arrays))

            next_chunk = 0
            for item in self._metadata_items:
                image_data = get_rgb_index_mask(item, self._rng)
                if image_data is None:
                    continue
                rgbs, img_indices, keep_mask = image_data
                n = rgbs.shape[0]
                if self._shared_intrinsics:
                    pix = np.arange(item.W * item.H, dtype=np.int64)
                    if keep_mask is not None:
                        pix = pix[keep_mask]
                    cols = {"rgbs": rgbs, "image_indices": img_indices,
                            "pixel_indices": pix}
                else:
                    rays = compute_image_rays(
                        item.c2w, item.W, item.H, item.intrinsics,
                        self._center_pixels, self._near, self._far,
                        self._ray_altitude_range)
                    if keep_mask is not None:
                        rays = rays[keep_mask]
                    cols = {"rgbs": rgbs, "image_indices": img_indices,
                            "rays": rays.astype(np.float32)}

                perm = self._rng.permutation(n)
                cols = {k: v[perm] for k, v in cols.items()}
                # the first share rotates so chunks fill evenly
                for j, sl in enumerate(np.array_split(np.arange(n),
                                                      num_chunks)):
                    if sl.size == 0:
                        continue
                    cid = (next_chunk + j) % num_chunks
                    for k, v in cols.items():
                        buffers[cid].setdefault(k, []).append(v[sl])
                    buffered += sl.size
                next_chunk = (next_chunk + 1) % num_chunks
                if buffered >= max(disk_flush_size, 1):
                    for cid in range(num_chunks):
                        flush(cid)

            for cid in range(num_chunks):
                flush(cid)
            for f in pending:
                f.result()
        (chunk_dir / _MANIFEST).write_text(json.dumps(
            self._manifest(num_chunks, scale_factor)))
