"""Lazy per-image metadata + IO.

Port of ``switch_nerf_tpu/datasets/image_metadata.py``: lazy PIL load,
LANCZOS resize to the scaled W/H, zipped keep-mask loading (a torch-saved
boolean tensor, or a raw .npy payload), and the 2-parameter intrinsics
fixup (fx, fy -> fx, fy, W/2, H/2).
"""
from __future__ import annotations

import io
import pickle
from pathlib import Path
from typing import Optional
from zipfile import ZipFile

import numpy as np
import torch
from PIL import Image


class ImageMetadata:
    def __init__(self, image_path: Path, c2w: np.ndarray, w: int, h: int,
                 intrinsics: np.ndarray, image_index: int,
                 mask_path: Optional[Path], is_val: bool):
        self.image_path = Path(image_path)
        self.c2w = np.asarray(c2w, np.float32)
        self.W = int(w)
        self.H = int(h)
        intrinsics = np.asarray(intrinsics, np.float32).reshape(-1)
        if intrinsics.size == 2:
            intrinsics = np.array([intrinsics[0], intrinsics[1],
                                   self.W / 2.0, self.H / 2.0], np.float32)
        self.intrinsics = intrinsics
        self.image_index = int(image_index)
        self._mask_path = Path(mask_path) if mask_path is not None else None
        self.is_val = bool(is_val)

    def load_image(self) -> np.ndarray:
        """[H, W, 3] uint8."""
        with Image.open(self.image_path) as im:
            rgbs = im.convert("RGB")
        if rgbs.size != (self.W, self.H):
            rgbs = rgbs.resize((self.W, self.H), Image.LANCZOS)
        return np.asarray(rgbs, dtype=np.uint8)

    def load_mask(self) -> Optional[np.ndarray]:
        """[H, W] bool keep-mask, or None."""
        if self._mask_path is None:
            return None
        with ZipFile(self._mask_path) as zf:
            with zf.open(self._mask_path.name) as f:
                mask = _load_mask_payload(f)
        mask = np.asarray(mask)
        if mask.shape[0] != self.H or mask.shape[1] != self.W:
            # floor-sampling nearest like torch F.interpolate (PIL NEAREST
            # samples pixel centers and picks other source pixels)
            ys = (np.arange(self.H) * mask.shape[0] // self.H)
            xs = (np.arange(self.W) * mask.shape[1] // self.W)
            mask = mask[ys][:, xs]
        return mask.astype(bool)


def _load_mask_payload(fileobj) -> np.ndarray:
    """torch-saved bool tensor (Mega-NeRF format) or raw .npy."""
    data = fileobj.read()
    try:
        return torch.load(io.BytesIO(data), map_location="cpu").numpy()
    except (RuntimeError, pickle.UnpicklingError):
        pass          # not a torch payload: fall through to raw .npy
    out = np.load(io.BytesIO(data), allow_pickle=False)
    if not isinstance(out, np.ndarray):
        # np.load "succeeds" on any zip payload (.pt files are zips) by
        # returning an NpzFile: that is not a decoded mask
        raise RuntimeError("mask payload is neither a torch-saved tensor "
                           "nor a .npy array")
    return out
