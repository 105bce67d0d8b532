"""Gigapixel images (2-D image-fitting scenes).

Port of ``switch_nerf_tpu/datasets/nerf_data/load_gigapixel.py:18-35``:
one large image whose pixels are the targets, with each pixel centre's
coordinates in [-1, 1]. A --scale_factor below 1 scales the image down to
floor(scale * size) with PIL's bilinear resize; a whole factor above 1
divides its size.
"""
from __future__ import annotations

import math

import numpy as np
from PIL import Image

__all__ = ["load_gigapixel_data"]


def load_gigapixel_data(path, scale_factor: float = 1):
    """(pixels [H, W, 3] float32 in [0, 1], coords [H, W, 2] float32: x
    then y of each pixel centre in [-1, 1])."""
    # one image may exceed PIL's decompression-bomb limit on purpose
    limit, Image.MAX_IMAGE_PIXELS = Image.MAX_IMAGE_PIXELS, None
    try:
        with Image.open(path) as im:
            img = im.convert("RGB")
    finally:
        Image.MAX_IMAGE_PIXELS = limit
    if 0 < scale_factor < 1:
        img = img.resize((max(1, math.floor(img.width * scale_factor)),
                          max(1, math.floor(img.height * scale_factor))),
                         Image.BILINEAR)
    elif scale_factor > 1:
        img = img.resize((img.width // int(scale_factor),
                          img.height // int(scale_factor)), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    h, w = arr.shape[:2]
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    coords = np.stack([(xs + 0.5) / w * 2 - 1, (ys + 0.5) / h * 2 - 1], -1)
    return arr, coords.astype(np.float32)
