"""Per-image pixel selection and epoch sampling shared by the datasets.

Port of ``switch_nerf_tpu/datasets/dataset_utils.py``:
  * ``get_rgb_index_mask``: flattened rgbs, an int16 image-index vector and
    the keep mask. A val image trains on its LEFT half only; the number of
    kept pixels dropped from the right half is resampled, in the JAX
    package's draw order, into masked-out left-half pixels, so the image's
    ray count is kept (eval scores the right half).
  * ``EpochPermutationSampler``: one permutation per epoch keyed by (seed,
    epoch), the batch position by the global batch counter, so a resumed
    run replays the same batches.
  * ``poll_until``: the wait of the chunked datasets' processes for a file
    another process publishes (the chunk manifest, a writer's marker).
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, TypeVar

import numpy as np

from switch_nerf_torch.datasets.image_metadata import ImageMetadata

INT16_MAX = np.iinfo(np.int16).max


def get_rgb_index_mask(metadata: ImageMetadata, rng: np.random.Generator
                       ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                           Optional[np.ndarray]]]:
    """(rgbs [N, 3] uint8, image indices [N] int16, keep mask [H*W] or
    None), or None when the mask keeps no pixel. Draws from ``rng`` only
    for a masked val image (``rng.permutation`` of the left-half
    candidates)."""
    rgbs = metadata.load_image().reshape(-1, 3)
    keep_mask = metadata.load_mask()

    if metadata.is_val:
        h, w = metadata.H, metadata.W
        if keep_mask is None:
            keep_mask = np.ones((h, w), dtype=bool)
        else:
            discard_pos_count = int(keep_mask[:, w // 2:].sum())
            candidates = np.arange(h * w).reshape(h, w)[:, :w // 2]
            candidates = candidates[~keep_mask[:, :w // 2]].reshape(-1)
            to_add = rng.permutation(candidates)[:discard_pos_count]
            flat = keep_mask.reshape(-1)
            flat[to_add] = True
            keep_mask = flat.reshape(h, w)
        keep_mask[:, w // 2:] = False

    if keep_mask is not None:
        if not keep_mask.any():
            return None
        keep_mask = keep_mask.reshape(-1)
        rgbs = rgbs[keep_mask]

    if metadata.image_index > INT16_MAX:
        raise ValueError(f"image index {metadata.image_index} exceeds the "
                         "int16 chunk format")
    indices = np.full((rgbs.shape[0],), metadata.image_index, dtype=np.int16)
    return rgbs, indices, keep_mask


T = TypeVar("T")


def poll_until(check: Callable[[], Optional[T]], timeout_s: float = 3600.0,
               interval_s: float = 1.0,
               desc: str = "process 0 never published the chunk manifest"
               ) -> T:
    """Call ``check()`` every ``interval_s`` seconds until it returns
    something other than None, and return that; TimeoutError(desc) after
    ``timeout_s``."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        out = check()
        if out is not None:
            return out
        time.sleep(interval_s)
    raise TimeoutError(desc)


class EpochPermutationSampler:
    """Per-epoch permutation batch sampling.

    Every epoch visits each row once, in a permutation keyed by (seed,
    epoch); the position comes from the global batch counter, so a run
    resumed at batch k replays the uninterrupted run's batches with no
    carried random state. The trailing ``n % batch_size`` rows of an epoch
    are dropped.
    """

    def __init__(self, n_rows: int, seed: int):
        if n_rows <= 0:
            raise ValueError("EpochPermutationSampler over an empty dataset")
        self._n = n_rows
        self._seed = seed
        self._epoch = None
        self._perm = None

    def batch_indices(self, global_batch: int, batch_size: int) -> np.ndarray:
        per_epoch = max(self._n // batch_size, 1)
        epoch, pos = divmod(int(global_batch), per_epoch)
        if epoch != self._epoch:
            self._perm = np.random.default_rng(
                np.random.SeedSequence([self._seed, epoch])
            ).permutation(self._n)
            self._epoch = epoch
        idx = self._perm[pos * batch_size:(pos + 1) * batch_size]
        if idx.shape[0] < batch_size:
            # fewer rows than one batch: repeat the epoch's permutation
            idx = np.resize(self._perm, batch_size)
        return idx
