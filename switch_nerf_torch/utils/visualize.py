"""Visualization helpers for eval outputs.

Port of ``switch_nerf_tpu/utils/visualize.py``:
  * visualize_scalars: log-scale positive depths, 5/95-quantile normalize,
    inverted INFERNO colormap (grayscale where cv2 is missing).
  * voc_palette: expert-id segmentation colours.
"""
from __future__ import annotations

import numpy as np


def visualize_scalars(scalar_tensor: np.ndarray,
                      colormap: int | None = None) -> np.ndarray:
    """[H, W] scalars -> [H, W, 3] uint8 colormapped.

    colormap: a cv2.COLORMAP_* integer (default INFERNO)."""
    to_use = scalar_tensor.astype(np.float64).copy()
    while to_use.ndim > 2:
        to_use = to_use[..., 0]

    # log(d + 1e-8) over all pixels: zero depths land at the low extreme
    to_use = np.log(np.maximum(to_use, 0.0) + 1e-8)
    lo, hi = np.quantile(to_use, [0.05, 0.95])
    scale = max(hi - lo, 1e-8)
    norm = np.clip((to_use - lo) / scale, 0.0, 1.0)

    try:
        import cv2
        cmap = cv2.COLORMAP_INFERNO if colormap is None else int(colormap)
        img = cv2.applyColorMap(
            ((1.0 - norm) * 255).astype(np.uint8), cmap)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except Exception:
        # grayscale fallback, as in the JAX package
        g = ((1.0 - norm) * 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)


def voc_palette(num_classes: int = 256) -> np.ndarray:
    """PASCAL-VOC color palette [N, 3] uint8 (bit-shuffled class colors)."""
    def bitget(byteval, idx):
        return (byteval & (1 << idx)) != 0

    palette = np.zeros((num_classes, 3), dtype=np.uint8)
    for k in range(num_classes):
        r = g = b = 0
        c = k
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        palette[k] = [r, g, b]
    return palette
