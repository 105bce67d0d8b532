"""Extract a PlenOctree-style sparse octree from a trained (MoE) NeRF: the
port's counterpart of ``scripts/create_octree_moe.py``.

    python -m switch_nerf_torch.create_octree_moe <training flags> \
        --ckpt_path=CKPT --output=tree.npz --init_grid_depth=8 \
        --alpha_thresh=0.01 --masking_mode=sigma

The checkpoint's model (an SH model: --sh_deg with an SH colour head) is
queried on the card in --model_chunk_size-point calls with the direction
pinned to +x and the appearance to --embedding_index, as the JAX script
pins them: once over the grid of the scene's box (the Mega-NeRF sphere's,
else [-1, 1]^3) to fit the box to the cells above --scale_alpha_thresh,
once over the fitted box's grid to mask the cells (--masking_mode sigma:
sigma above --alpha_thresh's; weight: the most ray-marching weight over
the train cameras above --weight_thresh), then --samples_per_cell random
points a leaf, averaged. The tree is built on the host (``octree.py``) and
written in the JAX package's npz layout. Runs on ``cuda``;
``main(hparams, device="cpu")`` runs the plain versions.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from switch_nerf_torch.config import get_opts_base
from switch_nerf_torch.utils.crash import cli_entry
from switch_nerf_torch.utils.logger import main_log


def get_extraction_opts():
    parser = get_opts_base()
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--exp_name", type=str, default="/tmp/octree_exp")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--alpha_thresh", type=float, default=0.01)
    parser.add_argument("--scale_alpha_thresh", type=float, default=0.01)
    parser.add_argument("--init_grid_depth", type=int, default=8)
    parser.add_argument("--samples_per_cell", type=int, default=8)
    parser.add_argument("--masking_mode", type=str, default="sigma",
                        choices=["sigma", "weight"])
    parser.add_argument("--weight_thresh", type=float, default=0.001)
    parser.add_argument("--embedding_index", type=int, default=0)
    parser.add_argument("--camera_params", type=int, nargs="+",
                        default=[800, 800, 400, 400, 400, 400])
    return parser


def make_query(model: torch.nn.Module, hparams, device
               ) -> Callable[[np.ndarray], np.ndarray]:
    """query(pts [N, 3] float32) -> the eval model's outputs [N, C] on the
    host, in calls of --model_chunk_size points, the last one padded with
    copies of the last point as the JAX script pads it (padded dispatch
    routes a call's points together)."""
    bs = hparams.model_chunk_size

    @torch.no_grad()
    def call(pts: np.ndarray) -> torch.Tensor:
        xyz = torch.from_numpy(pts).to(device)
        parts = [xyz]
        if hparams.pos_dir_dim > 0:
            d = torch.zeros_like(xyz)
            d[:, 0] = 1.0
            parts.append(d)
        if hparams.appearance_dim > 0:
            parts.append(torch.full((xyz.shape[0], 1),
                                    float(hparams.embedding_index),
                                    device=device))
        out = model(torch.cat(parts, -1), train=False)
        return out["outputs"] if isinstance(out, dict) else out

    def query(pts: np.ndarray) -> np.ndarray:
        n = pts.shape[0]
        pad = (-n) % bs
        if pad:
            pts = np.concatenate([pts, np.repeat(pts[-1:], pad, 0)], 0)
        outs = [call(np.ascontiguousarray(pts[i:i + bs], np.float32))
                .float().cpu() for i in range(0, pts.shape[0], bs)]
        return torch.cat(outs).numpy()[:n]
    return query


@cli_entry(parser=get_extraction_opts)
def main(hparams=None, device=None):
    """Write the tree to --output; returns it."""
    from switch_nerf_torch.octree import (build_octree, grid_points,
                                          grid_weights,
                                          sigma_threshold_from_alpha)
    from switch_nerf_torch.runner import Runner

    runner = Runner(hparams, set_experiment_path=False, device=device)
    state = runner._load_eval_state()            # the whole model
    query = make_query(state.model, hparams, runner.device)
    reso = 2 ** hparams.init_grid_depth
    fmt = (f"SH{(hparams.sh_deg + 1) ** 2}" if hparams.sh_deg is not None
           else "RGBA")

    # step 0: fit the box to the occupied cells
    center, radius = [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]
    if runner.sphere_center is not None:
        center = np.asarray(runner.sphere_center).tolist()
        radius = np.asarray(runner.sphere_radius).tolist()
    sigma_thresh = sigma_threshold_from_alpha(hparams.scale_alpha_thresh,
                                              reso)
    pts = grid_points(center, radius, reso)
    sig = query(pts)[:, -1]
    occ_pts = pts[sig >= sigma_thresh]
    if occ_pts.shape[0] == 0:
        raise SystemExit("no occupied cells above scale_alpha_thresh")
    lc = occ_pts.min(0) - np.asarray(radius) / reso
    uc = occ_pts.max(0) + np.asarray(radius) / reso
    center = ((lc + uc) * 0.5).tolist()
    radius = ((uc - lc) * 0.5).tolist()
    main_log(f"auto-scaled bbox: center={center} radius={radius}")

    # step 1: the fitted box's grid, masked
    pts = grid_points(center, radius, reso)
    sigma_grid = query(pts)[:, -1].reshape(reso, reso, reso)
    del pts
    if hparams.masking_mode == "sigma":
        thr = sigma_threshold_from_alpha(hparams.alpha_thresh, reso)
        occupied = sigma_grid >= thr
    else:
        poses = np.stack([m.c2w for m in runner.train_items])
        maxw = grid_weights(sigma_grid, poses, center, radius,
                            tuple(hparams.camera_params))
        occupied = maxw >= hparams.weight_thresh
    main_log(f"occupied cells: {int(occupied.sum())}/{reso ** 3}")

    # steps 2 and 3: each leaf's mean over samples_per_cell random points,
    # drawn and queried a block of cells at a time (one seeded stream, so
    # the draws and the query calls are the JAX script's)
    rng = np.random.default_rng(0)
    rad = np.asarray(radius, np.float32)
    cen = np.asarray(center, np.float32)
    spc = hparams.samples_per_cell
    block = hparams.model_chunk_size

    def leaf_payload(cells: np.ndarray) -> np.ndarray:
        out = []
        for lo in range(0, cells.shape[0], block):
            c = cells[lo:lo + block]
            offs = rng.random((c.shape[0], spc, 3)).astype(np.float32)
            world = (c[:, None, :] + offs) / reso * (2 * rad) + (cen - rad)
            out.append(query(world.reshape(-1, 3))
                       .reshape(c.shape[0], spc, -1).mean(axis=1))
        return np.concatenate(out) if out else np.zeros((0, 1), np.float32)

    tree = build_octree(occupied, leaf_payload, center, radius, fmt)
    tree.save(hparams.output)
    main_log(f"wrote {hparams.output}: {tree.data.shape[0]} leaves, "
             f"{tree.child.shape[0]} internal nodes, format {fmt}")
    return tree


if __name__ == "__main__":
    main()
