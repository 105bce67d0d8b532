"""TensorBoard summary writing (scalars + images).

Port of ``switch_nerf_tpu/utils/tb.py``. Backend:
``torch.utils.tensorboard.SummaryWriter``, which needs the ``tensorboard``
package; without it the writer is a no-op, as the JAX one is without
TensorFlow.
"""
from __future__ import annotations

import logging

import numpy as np


class SummaryWriter:
    def __init__(self, log_dir):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter as _Writer
        except ImportError:
            # the one case where logging nothing is the intent
            return
        try:
            self._writer = _Writer(str(log_dir))
        except OSError as e:
            # a bad log_dir must not pass silently
            logging.getLogger(__name__).warning(
                "TensorBoard writer creation failed for %s (%s): "
                "scalar/image logging DISABLED for this run", log_dir, e)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image: [H, W, 3] float in [0,1] or uint8."""
        if self._writer is None:
            return
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        self._writer.add_image(tag, img, int(step), dataformats="HWC")

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()
