"""The scene geometry a Mega-NeRF configuration derives from its cameras:
the foreground ellipsoid around them, stretched over the altitude range
and scaled until every camera and its projections onto the range's two
planes lie inside, times ellipse_scale_factor."""
from __future__ import annotations

import numpy as np


def ellipse(camera_xyz: np.ndarray, altitude: tuple, origin_x: float,
            scale: float, factor: float):
    """camera_xyz [n, 3] in the pose-normalised frame (x down); altitude
    (low, high) in scene units; origin_x and scale the frame's. Returns
    (center [3], radius [3]) float32."""
    lo, hi = ((a - origin_x) / scale for a in altitude)
    cams = np.asarray(camera_xyz, np.float64)
    ground, air = cams.copy(), cams.copy()
    ground[:, 0], air[:, 0] = hi, lo
    used = np.concatenate([cams, air, ground])
    mn, mx = cams.min(0), cams.max(0).copy()
    mx[0] = hi
    center = (mx + mn) * 0.5
    radius = (mx - mn) * 0.5
    s = np.linalg.norm((used - center) / radius, axis=-1).max()
    return (center.astype(np.float32),
            (radius * s * factor).astype(np.float32))
