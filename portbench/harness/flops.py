"""Operation and byte counts of the benchmark's models, and the card's
peaks.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity):
989 TFLOP/s bf16, 494.7 TFLOP/s TF32, 67 TFLOP/s fp32 on the CUDA cores,
3.35 TB/s of HBM. A card may be held below its 700 W limit; a share is
always against these peaks, the limit printed beside it.

The expert chain of one MoE call (E experts, C rows each, width M, L
layers) computes, forward, 2 E C M^2 L operations and moves x and its
output (E C M elements each), the weights and biases (L E (M^2 + M));
backward, the dx and dW products, 4 E C M^2 L operations, reading x, the
output gradient and the weights and writing dx and fp32 dW and db (the
kernel's own recompute is not counted). No-drop calls count the rows
routed (E C is the call's token count). A share of the roofline is the
larger of operations over the peak rate and bytes over the bandwidth,
over the time measured.
"""
from __future__ import annotations

import math
from typing import Dict, List

PEAK_FLOPS = {"bf16": 989e12, "tf32": 494.7e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def chain_fwd(rows: int, m: int, layers: int, elem: int,
              experts: int) -> Dict[str, float]:
    """One forward chain over `rows` tokens in all (E C)."""
    return {"flops": 2.0 * rows * m * m * layers,
            "bytes": (2.0 * rows * m * elem
                      + experts * layers * (m * m + m) * elem)}


def chain_bwd(rows: int, m: int, layers: int, elem: int,
              experts: int) -> Dict[str, float]:
    """One backward chain (dx and dW)."""
    return {"flops": 4.0 * rows * m * m * layers,
            "bytes": (3.0 * rows * m * elem
                      + experts * layers * (m * m + m) * (elem + 4))}


def bound_s(counts: List[Dict[str, float]], dtype: str) -> float:
    """The least time for these calls: the sum over calls of the larger of
    operations over the peak and bytes over the bandwidth."""
    return sum(max(c["flops"] / PEAK_FLOPS[dtype], c["bytes"] / PEAK_BYTES)
               for c in counts)


def calls(points: int, chunk: int) -> List[int]:
    """The token counts of the model calls over `points` points: whole
    chunks, then one shorter call for the rest."""
    step = min(chunk, points)
    return [min(step, points - lo) for lo in range(0, points, step)]


def capacity_rows(tokens: int, experts: int, factor: float) -> int:
    """E C of a padded call: every expert's capacity int(factor *
    ceil(tokens / E)) of slots."""
    return experts * int(factor * math.ceil(tokens / experts))


def mlp_flops(dims: List[tuple]) -> float:
    """2 * sum(in * out) over the layers of a point's pass."""
    return 2.0 * sum(a * b for a, b in dims)


def fg_point_flops(cfg: dict) -> float:
    """Useful forward operations of one foreground point: every product of
    the NeRF-MoE, the routed expert's chain only."""
    m = cfg["model"]
    w = m["width"]
    pe = 3 * (1 + 2 * m["pos_xyz_dim"])
    dir_in = w + 3 * (1 + 2 * m["pos_dir_dim"]) + m["appearance_dim"]
    dims = [(pe, w), (w, w), (w, w), (w, m["experts"])]
    dims += [(w, w)] * m["expert_layers"]
    dims += [(w, 1), (w, w), (dir_in, m["color_width"]),
             (m["color_width"], 3)]
    return mlp_flops(dims)


def bg_point_flops(cfg: dict) -> float:
    """Useful forward operations of one background point (dense NeRF)."""
    b = cfg.get("bg_model")
    if not b:
        return 0.0
    w = b["width"]
    pe = 4 * (1 + 2 * b["pos_xyz_dim"])
    dims, width = [], pe
    for i in range(b["layers"]):
        if i in b["skips"]:
            width += pe
        dims.append((width, w))
        width = w
    dir_in = w + 3 * (1 + 2 * b["pos_dir_dim"]) + b["appearance_dim"]
    dims += [(w, 1), (w, w), (dir_in, w // 2), (w // 2, 3)]
    return mlp_flops(dims)


def points_per_ray(cfg: dict) -> Dict[str, int]:
    """Model queries of one ray: foreground (coarse, fine) and background."""
    r = cfg["render"]
    return {"fg_coarse": r["coarse"], "fg_fine": r["fine"],
            "bg": r["coarse"] // 2 + r["fine"] // 2}


def ray_flops(cfg: dict, train: bool) -> float:
    """Useful model operations a ray: forward, times 3 for training
    (forward and backward), no recompute and no padded slot counted."""
    p = points_per_ray(cfg)
    fwd = ((p["fg_coarse"] + p["fg_fine"]) * fg_point_flops(cfg)
           + p["bg"] * bg_point_flops(cfg))
    return fwd * (3.0 if train else 1.0)


def chain_counts(cfg: dict, rays: int, train: bool, remat: bool
                 ) -> List[Dict[str, float]]:
    """Every expert-chain launch of one step or request of `rays` rays:
    each foreground pass cut into calls; a padded call at its capacity
    slots, a no-drop one at its tokens; training adds the backward and,
    under remat, the forward again."""
    m = cfg["model"]
    elem = 2 if cfg["amp"] else 4
    w, layers, e = m["width"], m["expert_layers"], m["experts"]
    p = points_per_ray(cfg)
    out = []
    for pts in (rays * p["fg_coarse"], rays * p["fg_fine"]):
        for tokens in calls(pts, cfg["render"]["chunk"]):
            drop = train or cfg["render"]["eval_drop"]
            rows = (capacity_rows(tokens, e, m["capacity_factor"]) if drop
                    else tokens)
            fwd = chain_fwd(rows, w, layers, elem, e)
            out.append(fwd)
            if train:
                if remat:
                    out.append(dict(fwd))
                out.append(chain_bwd(rows, w, layers, elem, e))
    return out
