"""The plain reference's training steps and render requests.

``train_steps`` follows a training run from the seeded weights through
its first steps on given batches: the loss of each step (photometric MSE
plus the load-balance weight times the mean gate loss of the passes), the gradient of the first
step, and each leaf's change after the last. Adam with the configuration's
betas, epsilon and exponentially decaying learning rate, as
``torch.optim.Adam`` computes it. ``render`` answers one request of rays.

float32 with TF32 off (``plain_matmuls``): the reference's products run
on the CUDA cores in float32.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from . import nets
from .render import Chunks, render_mega


@contextlib.contextmanager
def plain_matmuls():
    """float32 products with TF32 off, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _models(cfg: dict, fg: Dict, bg: Optional[Dict], drop: bool,
            prec: nets.Prec):
    def fg_fn(x, noise):
        return nets.nerf_moe(fg, x, noise, cfg, drop, prec)

    def bg_fn(x, noise):
        return nets.bg_nerf(bg, x, noise, cfg, prec)
    return fg_fn, (bg_fn if bg is not None else None)


def _render(cfg: dict, fg_fn, bg_fn, batch: Dict, generator, train: bool,
            scene):
    r = cfg["render"]
    noise = r["sigma_noise_std"] if (train and r["sigma_noise"]) else 0.0
    fg = Chunks(fg_fn, r["chunk"], generator, noise, train)
    idx = batch["image_indices"]
    bg = Chunks(bg_fn, r["bg_chunk"], generator, noise, train)
    res = render_mega(fg, bg, batch["rays"], idx, scene[0], scene[1],
                      r["coarse"], r["fine"], generator if train else None)
    return res, [bg, fg]


def losses(res: Dict, rgbs: torch.Tensor, cfg: dict,
           alter: float = 0.0) -> Dict:
    """The training loss of one pass's results (`alter`: a fault for the
    limits' readings, added to the first tenth of the rays' colours)."""
    if alter:
        rgb = res["rgb_fine"]
        n = max(rgb.shape[0] // 10, 1)
        res = dict(res, rgb_fine=torch.cat([rgb[:n] + alter, rgb[n:]]))
    loss = torch.mean((res["rgb_fine"] - rgbs) ** 2)
    gate = (torch.mean(res["gate_loss_fine"])
            + torch.mean(res["gate_loss_coarse"])) / 2.0
    return {"loss": loss, "gate_loss": gate,
            "all_loss": loss + cfg["train"]["l_aux_weight"] * gate}


def train_steps(cfg: dict, fg: Dict[str, torch.Tensor],
                bg: Optional[Dict[str, torch.Tensor]], batches: List[Dict],
                generator: torch.Generator, scene=None,
                prec: nets.Prec = nets.FP32, alter: float = 0.0) -> Dict:
    """Train `fg` / `bg` (float32 leaves, changed in place) one Adam step a
    batch, the step's numbers drawn from `generator`. Returns {"loss":
    [all_loss of each step], "grad": {name: first step's gradient},
    "change": {name: the leaf's change over all the steps}} (names
    prefixed "fg." / "bg.")."""
    t = cfg["train"]
    leaves = {f"fg.{k}": v for k, v in fg.items()}
    if bg is not None:
        leaves.update({f"bg.{k}": v for k, v in bg.items()})
    start = {k: v.detach().clone() for k, v in leaves.items()}
    for v in leaves.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(list(leaves.values()), lr=t["lr"],
                           betas=tuple(t["betas"]), eps=t["eps"])
    gamma = t["lr_decay_factor"] ** (1.0 / t["train_iterations"])
    fg_fn, bg_fn = _models(cfg, fg, bg, True, prec)
    out = {"loss": [], "grad": {}, "change": {}}
    with plain_matmuls():
        for step, batch in enumerate(batches):
            res, chunks = _render(cfg, fg_fn, bg_fn, batch, generator, True,
                                  scene)
            m = losses(res, batch["rgbs"], cfg, alter)
            m["all_loss"].backward()
            for c in chunks:
                c.backward()
            out["loss"].append(float(m["all_loss"].detach()))
            if step == 0:
                out["grad"] = {k: v.grad.detach().clone()
                               for k, v in leaves.items()}
            for g in opt.param_groups:
                g["lr"] = t["lr"] * gamma ** step
            opt.step()
            opt.zero_grad(set_to_none=True)
    out["change"] = {k: (v.detach() - start[k]) for k, v in leaves.items()}
    for v in leaves.values():
        v.requires_grad_(False)
    return out


@torch.no_grad()
def render(cfg: dict, fg: Dict, bg: Optional[Dict], batch: Dict, scene=None,
           prec: nets.Prec = nets.FP32) -> Dict:
    """One request's answers: rgb_fine [N, 3] and depth_fine [N], with
    the configuration's serving dispatch (no token dropped unless it says
    so)."""
    fg_fn, bg_fn = _models(cfg, fg, bg, cfg["render"]["eval_drop"], prec)
    with plain_matmuls():
        res, _ = _render(cfg, fg_fn, bg_fn, batch, None, False, scene)
    return {"rgb_fine": res["rgb_fine"], "depth_fine": res["depth_fine"]}
