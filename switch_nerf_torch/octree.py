"""Sparse-octree (PlenOctree-style) extraction without svox.

Port of ``switch_nerf_tpu/octree.py:39-207``: an ``Octree`` (save, load,
nearest-leaf ``query``), ``build_octree`` from a full-resolution occupancy
grid and a leaf-payload function, ``grid_points`` (cell centres),
``sigma_threshold_from_alpha`` and ``grid_weights`` (the most
volume-rendering weight a cell gets over the training cameras, marched in
numpy). The model queries that fill the grids run on the card
(``create_octree_moe.py``); the tree is built on the host.

Storage (npz, the JAX package's layout, so that either package reads the
other's trees):
    child   [n_internal, 8] int32   child index: >= 0 internal, -1 empty,
                                    -(2 + leaf_id) leaf
    data    [n_leaves, D]  float32  payload (SH coefficients | rgb), sigma
    center  [3], radius [3] float32, depth int32, data_format (e.g. "SH9")

Internal nodes are numbered breadth first, each node's children in code
order (code = 4 x + 2 y + z), and leaves in the occupied cells' row-major
order, as the JAX package's queue numbers them; here a level is numbered
at once with numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from switch_nerf_torch.datasets.ray_utils import get_ray_directions

__all__ = ["Octree", "build_octree", "grid_points",
           "sigma_threshold_from_alpha", "grid_weights"]

# child code -> (dx, dy, dz)
_CODES = np.array([[c >> 2 & 1, c >> 1 & 1, c & 1] for c in range(8)],
                  np.int64)


@dataclass
class Octree:
    child: np.ndarray          # [n_internal, 8] int32
    data: np.ndarray           # [n_leaves, D] float32
    center: np.ndarray         # [3]
    radius: np.ndarray         # [3]
    depth: int
    data_format: str

    def save(self, path) -> None:
        np.savez(path, child=self.child, data=self.data, center=self.center,
                 radius=self.radius, depth=np.int32(self.depth),
                 data_format=np.str_(self.data_format))

    @staticmethod
    def load(path) -> "Octree":
        z = np.load(path, allow_pickle=False)
        return Octree(child=z["child"], data=z["data"], center=z["center"],
                      radius=z["radius"], depth=int(z["depth"]),
                      data_format=str(z["data_format"]))

    def query(self, pts: np.ndarray) -> np.ndarray:
        """The payload of the leaf holding each of [N, 3] world points
        (zeros in empty space and outside the box)."""
        n = pts.shape[0]
        out = np.zeros((n, self.data.shape[1]), np.float32)
        u = (pts - (self.center - self.radius)) / (2 * self.radius)
        valid = np.all((u >= 0) & (u < 1), axis=1)
        idx = np.where(valid)[0]
        u = u[idx]
        node = np.zeros(idx.shape[0], np.int64)
        for _ in range(self.depth):
            u = u * 2
            cell = np.floor(u).astype(np.int64)
            u = u - cell
            code = cell[:, 0] * 4 + cell[:, 1] * 2 + cell[:, 2]
            nxt = self.child[node, code]
            leaf = nxt <= -2
            out[idx[leaf]] = self.data[-(nxt[leaf] + 2)]
            alive = nxt >= 0
            idx, u, node = idx[alive], u[alive], nxt[alive].astype(np.int64)
            if idx.size == 0:
                break
        return out


def build_octree(occupied: np.ndarray, leaf_payload: Callable,
                 center, radius, data_format: str) -> Octree:
    """occupied: [R, R, R] bool at the full resolution R = 2**depth;
    leaf_payload(cells [L, 3] int64, in row-major order) -> [L, D]."""
    reso = occupied.shape[0]
    depth = int(np.log2(reso))
    if 2 ** depth != reso:
        raise ValueError(f"grid side {reso} is not a power of 2")

    occ_cells = np.argwhere(occupied)                       # [L, 3]
    payload = leaf_payload(occ_cells).astype(np.float32)

    # occupancy pyramid, coarse to fine: levels[l] is the children grid of
    # the nodes at tree level l (side 2**(l+1))
    levels = [occupied]
    for _ in range(depth - 1):
        o = levels[-1]
        r = o.shape[0] // 2
        levels.append(o.reshape(r, 2, r, 2, r, 2).any(axis=(1, 3, 5)))
    levels = levels[::-1]

    leaf_id = -np.ones(occupied.shape, np.int64)
    leaf_id[tuple(occ_cells.T)] = np.arange(occ_cells.shape[0])

    rows = [np.full((1, 8), -1, np.int64)]
    cells = np.zeros((1, 3), np.int64)          # this level's nodes, in order
    first = 0                                   # the id of cells[0]
    for level in range(depth):
        kids = cells[:, None, :] * 2 + _CODES[None]          # [n, 8, 3]
        block = rows[-1]
        if level + 1 < depth:
            occ = levels[level][kids[..., 0], kids[..., 1], kids[..., 2]]
            n_new = int(occ.sum())
            ids = first + cells.shape[0] + np.arange(n_new)
            block[occ] = ids
            cells = kids[occ]
            first = first + block.shape[0]
            rows.append(np.full((n_new, 8), -1, np.int64))
        else:
            lid = leaf_id[kids[..., 0], kids[..., 1], kids[..., 2]]
            block[lid >= 0] = -(2 + lid[lid >= 0])
    child = np.concatenate(rows).astype(np.int32)
    return Octree(child=child, data=payload,
                  center=np.asarray(center, np.float32),
                  radius=np.asarray(radius, np.float32),
                  depth=depth, data_format=data_format)


def grid_points(center, radius, reso: int) -> np.ndarray:
    """Cell-centre world coordinates [R^3, 3], row-major over (x, y, z)."""
    center = np.asarray(center, np.float32)
    radius = np.asarray(radius, np.float32)
    arr = (np.arange(reso, dtype=np.float32) + 0.5) / reso
    axes = [center[i] - radius[i] + 2 * radius[i] * arr for i in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    return g.reshape(-1, 3)


def sigma_threshold_from_alpha(alpha_thresh: float, reso: int) -> float:
    """alpha = 1 - exp(-sigma * delta) >= t  <=>  sigma >= -ln(1-t)/delta,
    with delta a cell of the [-1, 1] box: 2 / reso."""
    approx_delta = 2.0 / reso
    return -np.log(1.0 - alpha_thresh) / approx_delta


def grid_weights(sigma_grid: np.ndarray, poses: np.ndarray,
                 center, radius, camera: Tuple[int, int, float, float,
                                               float, float],
                 n_steps: Optional[int] = None,
                 ray_subsample: int = 4) -> np.ndarray:
    """The most volume-rendering weight each grid cell receives over the
    cameras. sigma_grid: [R, R, R]; poses: [P, 3, 4] c2w; camera (W, H, fx,
    fy, cx, cy), pixel-centre rays subsampled by `ray_subsample` in each
    image dimension, marched at half a cell from where the box could
    begin (a camera may stand far outside it) over two box diagonals."""
    reso = sigma_grid.shape[0]
    w, h, fx, fy, cx, cy = camera
    n_steps = n_steps or reso * 4
    center = np.asarray(center, np.float32)
    radius = np.asarray(radius, np.float32)
    lo = center - radius
    span = 2 * radius

    maxw = np.zeros_like(sigma_grid, np.float32)
    dirs_cam = np.asarray(get_ray_directions(
        w, h, fx, fy, cx, cy, center_pixels=True))[
            ::ray_subsample, ::ray_subsample].reshape(-1, 3)
    diag = float(np.linalg.norm(span))

    for pose in poses:
        d = dirs_cam @ pose[:, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = pose[:, 3]
        t_entry = max(0.0, float(np.linalg.norm(o - center)) - diag)
        ts = np.linspace(t_entry + 1e-4, t_entry + 2 * diag, n_steps,
                         dtype=np.float32)
        delta = np.float32(ts[1] - ts[0])
        pts = o[None, None, :] + d[:, None, :] * ts[None, :, None]
        cell = np.floor((pts - lo) / span * reso).astype(np.int64)
        inside = np.all((cell >= 0) & (cell < reso), axis=-1)
        cc = np.clip(cell, 0, reso - 1)
        sig = sigma_grid[cc[..., 0], cc[..., 1], cc[..., 2]]
        sig = np.where(inside, sig, 0.0)
        alpha = 1.0 - np.exp(-sig * delta)
        trans = np.cumprod(1.0 - alpha + 1e-10, axis=-1)
        trans = np.concatenate(
            [np.ones_like(trans[:, :1]), trans[:, :-1]], axis=-1)
        wgt = alpha * trans
        flat = (cc[..., 0] * reso + cc[..., 1]) * reso + cc[..., 2]
        np.maximum.at(maxw.reshape(-1), flat[inside], wgt[inside])
    return maxw
