"""Minimal binary PLY point-cloud IO: xyz + rgba (or rgb) vertices, with
no plyfile dependency.

A copy of ``switch_nerf_tpu/utils/ply.py`` (the port imports nothing of
the JAX package): the files of ``Runner.eval_points`` and
``switch_nerf_torch.merge_points`` (read -> downsample -> merged write),
byte for byte the JAX package's.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

_DTYPE = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                   ("alpha", "u1")])
_DTYPE_RGB = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("red", "u1"), ("green", "u1"), ("blue", "u1")])


def write_ply_points(path, xyz: np.ndarray, colors: np.ndarray) -> None:
    """xyz [N,3] float; colors [N,4] (rgba) or [N,3] (rgb — the
    reference's plain segmentation clouds carry no alpha property,
    runner.py:2220-2222) -> binary_little_endian PLY."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    colors = np.asarray(colors, np.uint8)
    colors = colors.reshape(-1, colors.shape[-1])
    has_alpha = colors.shape[-1] == 4
    n = xyz.shape[0]
    props = ["property uchar red", "property uchar green",
             "property uchar blue"]
    if has_alpha:
        props.append("property uchar alpha")
    header = "\n".join([
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
        *props,
        "end_header",
    ]) + "\n"
    rec = np.empty(n, dtype=_DTYPE if has_alpha else _DTYPE_RGB)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["red"], rec["green"] = colors[:, 0], colors[:, 1]
    rec["blue"] = colors[:, 2]
    if has_alpha:
        rec["alpha"] = colors[:, 3]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def read_ply_points(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read a PLY written by write_ply_points -> (xyz [N,3],
    colors [N,4] or [N,3])."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    n = next(int(l.split()[-1]) for l in header
             if l.startswith("element vertex"))
    assert "format binary_little_endian 1.0" in header[1], header[1]
    has_alpha = "property uchar alpha" in header
    dt = _DTYPE if has_alpha else _DTYPE_RGB
    rec = np.frombuffer(data[end:end + n * dt.itemsize], dtype=dt)
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    chans = [rec["red"], rec["green"], rec["blue"]]
    if has_alpha:
        chans.append(rec["alpha"])
    return xyz, np.stack(chans, -1).astype(np.uint8)
