"""Chunked disk-shuffle dataset for Mega-NeRF-scale scenes.

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

In a data-parallel run (``process_count`` > 1, by default the process
group's size) each process keeps rows ``[index::count]`` of every chunk and
draws its batches (the per-process share of the global batch) from them;
the batch count comes from the chunk's global row count, so every process
agrees on it. The chunks are written cooperatively: every process runs the
same image loop on the same random stream and writes the chunk ids it
owns (``cid % count == index``), so the directory is the one a single
writer makes; process 0 cleans the directory first and publishes the
manifest last, once every writer's done marker is there. In a process
group the writers start behind a barrier; with process ids given by hand
(no group) they wait for process 0 to acknowledge a fresh nonce each, so
no marker of a crashed earlier write can start them.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from switch_nerf_torch.datasets.dataset_utils import (get_rgb_index_mask,
                                                      poll_until)
from switch_nerf_torch.datasets.image_metadata import ImageMetadata
from switch_nerf_torch.datasets.ray_utils import (_get_rays_inner,
                                                  compute_image_rays,
                                                  get_ray_directions)
from switch_nerf_torch.parallel import host

_MANIFEST = "manifest.json"


def process_share(process_index: Optional[int],
                  process_count: Optional[int]) -> tuple:
    """(index, count) of this process among the readers of a chunk
    directory: the process group's rank and size unless given."""
    return (host.rank() if process_index is None else int(process_index),
            host.world_size() if process_count is None
            else int(process_count))


def strided_batches(loaded: Dict[str, np.ndarray], rng: np.random.Generator,
                    batch_size: int, global_rows: int, process_count: int
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """The loaded rows in batches of ``batch_size`` from a fresh
    permutation, the last partial batch dropped. With several processes
    ``batch_size`` is the per-process share and the batch count comes from
    the chunk's global row count, the same on every process."""
    n = loaded["rgbs"].shape[0]
    order = rng.permutation(n)
    if process_count > 1:
        stop = global_rows // (batch_size * process_count) * batch_size
    else:
        stop = n - n % batch_size
    for i in range(0, stop, batch_size):
        idx = order[i:i + batch_size]
        yield {k: v[idx] for k, v in loaded.items()}


class FilesystemDataset:
    def __init__(self, metadata_items: List[ImageMetadata], near: float,
                 far: float, ray_altitude_range: Optional[Sequence[float]],
                 center_pixels: bool, chunk_paths: Sequence[Path],
                 num_chunks: int, scale_factor: int, disk_flush_size: int,
                 shuffle_chunk: bool = False, seed: int = 42,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self._process_index, self._process_count = process_share(
            process_index, process_count)
        self._global_rows = 0
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
            if self._process_index != 0:
                # process 0 publishes the manifest once every part is on
                # disk
                chunk_dir = poll_until(lambda: self._existing_chunk_dir(
                    chunk_paths, num_chunks, scale_factor), interval_s=0.2)

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
        self._global_rows = self._loaded.pop("_n_global")
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
        n_global = out["rgbs"].shape[0]
        if self._process_count > 1:
            # this process's rows only; rays are rebuilt after the cut
            sl = slice(self._process_index, None, self._process_count)
            out = {k: v[sl] for k, v in out.items()}
        if "rays" in out:
            rays = out["rays"].astype(np.float32)
        else:
            rays = self._reconstruct_rays(out["pixel_indices"],
                                          out["image_indices"])
        return {"rgbs": out["rgbs"].astype(np.float32) / 255.0,
                "rays": rays,
                "image_indices": out["image_indices"].astype(np.float32),
                "_n_global": n_global}

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
        """The loaded chunk's rows (this process's share of them) in
        batches of a fresh permutation, the last partial batch dropped;
        ``strided_batches``."""
        if self._loaded is None:
            raise RuntimeError("call load_chunk() first")
        self._batch_rng_pre_draw = self._batch_rng.bit_generator.state
        return strided_batches(self._loaded, self._batch_rng, batch_size,
                               self._global_rows, self._process_count)

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
        """Write this process's chunk ids (all of them in one process); see
        the module docstring for the cooperative protocol."""
        pi, pc = self._process_index, self._process_count
        owned = [cid for cid in range(num_chunks) if cid % pc == pi]
        self._start_writing(chunk_dir, num_chunks)
        buffers: List[Dict[str, List[np.ndarray]]] = [
            {} for _ in range(num_chunks)]
        part_ids = [0] * num_chunks
        pending: List[Future] = []
        buffered = 0

        with ThreadPoolExecutor(max_workers=10) as pool:
            def flush(cid: int) -> None:
                if not buffers[cid]:
                    return
                arrays = {k: np.concatenate(v)
                          for k, v in buffers[cid].items()}
                path = (chunk_dir / f"chunk_{cid:04d}"
                        / f"part_{part_ids[cid]:04d}.npz")
                part_ids[cid] += 1
                buffers[cid] = {}
                pending.append(pool.submit(np.savez, path, **arrays))

            next_chunk = 0
            for item in self._metadata_items:
                if pi == 0 and self._handshake:
                    # writers that announce themselves late are acked
                    # while process 0 writes
                    self._publish_acks(chunk_dir)
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
                # the first share rotates so chunks fill evenly; every
                # process computes the same split and keeps its own chunks'
                for j, sl in enumerate(np.array_split(np.arange(n),
                                                      num_chunks)):
                    cid = (next_chunk + j) % num_chunks
                    if sl.size == 0 or cid % pc != pi:
                        continue
                    for k, v in cols.items():
                        buffers[cid].setdefault(k, []).append(v[sl])
                next_chunk = (next_chunk + 1) % num_chunks
                # every writer counts every row, so the parts end where a
                # single writer's end and the directories are the same
                buffered += n
                if buffered >= max(disk_flush_size, 1):
                    buffered = 0
                    for cid in owned:
                        flush(cid)

            for cid in owned:
                flush(cid)
            for f in pending:
                f.result()
        (chunk_dir / f".writer_done_{pi}").touch()
        if pi == 0:
            self._publish_manifest(chunk_dir, num_chunks, scale_factor)

    def _start_writing(self, chunk_dir: Path, num_chunks: int) -> None:
        """Process 0 removes what an interrupted write left (without a
        manifest the chunk dirs are leftovers: their stale parts would be
        read) and makes the chunk dirs; the other writers start only after
        that, behind a barrier in a process group, else once process 0
        has acked the nonce each wrote into ``.writer_intent_<i>``."""
        pc = self._process_count
        # the group's barrier when the group is the writers, the
        # filesystem handshake for process ids given by hand
        use_barrier = pc > 1 and host.world_size() == pc
        self._handshake = pc > 1 and not use_barrier
        ready = chunk_dir / ".chunks_ready"
        if self._process_index == 0:
            ready.unlink(missing_ok=True)
            for stale in chunk_dir.glob("chunk_*"):
                shutil.rmtree(stale)
            for stale in chunk_dir.glob(".writer_done_*"):
                stale.unlink()
            for i in range(num_chunks):
                (chunk_dir / f"chunk_{i:04d}").mkdir()
            if self._handshake:
                self._publish_acks(chunk_dir)
        elif self._handshake:
            nonce = uuid.uuid4().hex
            _atomic_write(chunk_dir
                          / f".writer_intent_{self._process_index}", nonce)

            def acked():
                try:
                    acks = json.loads(ready.read_text()).get("acks", {})
                except (OSError, ValueError):
                    return None          # missing or half written
                return acks.get(str(self._process_index)) == nonce or None

            poll_until(acked, desc="process 0 never acknowledged this "
                                   "writer's chunk-write intent")
        if use_barrier:
            host.barrier("chunk tree ready")

    def _publish_acks(self, chunk_dir: Path) -> None:
        """Process 0: ack every writer's intent nonce in .chunks_ready."""
        acks = {}
        for f in chunk_dir.glob(".writer_intent_*"):
            try:
                acks[f.name[len(".writer_intent_"):]] = f.read_text()
            except OSError:
                pass
        if acks != getattr(self, "_last_acks", None):
            self._last_acks = acks
            _atomic_write(chunk_dir / ".chunks_ready",
                          json.dumps({"acks": acks}))

    def _publish_manifest(self, chunk_dir: Path, num_chunks: int,
                          scale_factor: int) -> None:
        """Process 0: once every writer's done marker is there, remove the
        markers and write the manifest, which readers wait for."""
        pc = self._process_count

        def all_done():
            if self._handshake:
                self._publish_acks(chunk_dir)
            return all((chunk_dir / f".writer_done_{p}").exists()
                       for p in range(pc)) or None

        poll_until(all_done, interval_s=0.2,
                   desc="a cooperative chunk writer never finished")
        for pattern in (".writer_done_*", ".writer_intent_*"):
            for marker in chunk_dir.glob(pattern):
                marker.unlink()
        (chunk_dir / ".chunks_ready").unlink(missing_ok=True)
        # atomic: the other processes poll for it and read it whole
        _atomic_write(chunk_dir / _MANIFEST, json.dumps(
            self._manifest(num_chunks, scale_factor)))


def _atomic_write(path: Path, text: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    tmp.replace(path)
