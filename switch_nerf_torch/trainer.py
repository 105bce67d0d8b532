"""Training and evaluation steps of the port.

Port of ``switch_nerf_tpu/trainer.py``, classic (coarse-only with
--fine_samples 0), cascade (--use_cascade: a coarse and a fine model, the
coarse loss) and mip (``mip=True``: ``render/rendering_mip.py``, with the
coarse loss): ``SceneInfo``, ``render_config_from_hparams``,
``make_model_fn`` / ``make_model_fn_pair``, ``make_eval_step`` (the
serving path), and the training core:
``create_optimizer`` (Adam with the per-step exponential LR),
``compute_losses``, ``TrainState`` / ``create_train_state`` and
``make_train_step`` with gradient accumulation and the finite check.

The recipe mirrors the JAX one:

    state = create_train_state(hparams, model, bg_model)
    train_step = make_train_step(hparams, render_cfg, scene)
    state, metrics = train_step(state, batch)

A torch module holds its own parameters, so the state holds the modules
(where the JAX state holds the parameter tree) and the step updates them
in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from switch_nerf_torch import bridge, resolve_device
from switch_nerf_torch.models.cascade import Cascade
from switch_nerf_torch.models.experts import hold_for_pass
from switch_nerf_torch.parallel import chunks, experts, host, mesh
from switch_nerf_torch.parallel.zero import ZeroAdam
from switch_nerf_torch.render.rendering import RenderConfig, render_rays
from switch_nerf_torch.render.rendering_mip import render_rays_mip

__all__ = ["SceneInfo", "render_config_from_hparams", "make_model_fn",
           "make_model_fn_pair", "make_eval_step", "lr_schedule",
           "create_optimizer", "compute_losses", "TrainState",
           "create_train_state", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class SceneInfo:
    """Static per-scene geometry for the fg/bg split."""
    sphere_center: Optional[Any] = None   # [3]
    sphere_radius: Optional[Any] = None   # [3] (ellipse) or scalar


def render_config_from_hparams(hparams) -> RenderConfig:
    return RenderConfig(
        coarse_samples=hparams.coarse_samples,
        fine_samples=hparams.fine_samples,
        perturb=hparams.perturb,
        model_chunk_size=hparams.model_chunk_size,
        bg_model_chunk_size=getattr(hparams, "bg_model_chunk_size", None),
        pos_dir_dim=hparams.pos_dir_dim,
        use_cascade=getattr(hparams, "use_cascade", False),
        white_bkgd=hparams.white_bkgd,
        use_random_background_color=hparams.use_random_background_color,
        use_sigma_noise=hparams.use_sigma_noise,
        sigma_noise_std=hparams.sigma_noise_std,
        sh_deg=hparams.sh_deg,
        rgb_padding=hparams.rgb_padding if hparams.use_mip else None,
        weights_resample_padding=hparams.weights_resample_padding,
        stop_level_grad=hparams.stop_level_grad,
        use_mip=getattr(hparams, "use_mip", False),
        remat_chunks=getattr(hparams, "remat", True),
        **{k: getattr(hparams, k, False) for k in (
            "return_pts", "return_pts_rgb", "return_pts_alpha",
            "return_sigma", "return_alpha")})


def make_model_fn(model: nn.Module,
                  use_coarse: Optional[bool] = None) -> Callable:
    """Adapt a module to the renderer's contract:
    model_fn(points [P, D], sigma_noise [P, 1] | None, train, generator) ->
    (outputs [P, 4], moe_loss [L]). The model's training draws (dropout,
    gate noise) come from `generator`. use_coarse selects the level of a
    ``Cascade``."""
    kwargs = {} if use_coarse is None else {"use_coarse": use_coarse}

    def model_fn(pts, sigma_noise=None, train=False, generator=None):
        out = model(pts, sigma_noise=sigma_noise, train=train,
                    generator=generator, **kwargs)
        if isinstance(out, dict):
            moe = out["extras"].get("moe_loss")
            if moe is None:
                moe = pts.new_zeros((0,))
            return out["outputs"], moe
        return out, pts.new_zeros((0,))
    return model_fn


def make_model_fn_pair(model: Optional[nn.Module]
                       ) -> Tuple[Optional[Callable], Optional[Callable]]:
    """(coarse model_fn, fine model_fn or None): the fine one differs only
    for a ``Cascade`` (JAX ``trainer.py:138-148``)."""
    if model is None:
        return None, None
    if isinstance(model, Cascade):
        return (make_model_fn(model, use_coarse=True),
                make_model_fn(model, use_coarse=False))
    return make_model_fn(model), None


def _as_tensor(v, device) -> Optional[torch.Tensor]:
    if v is None:
        return None
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _check_on(dev: torch.device, **modules) -> None:
    for name, m in modules.items():
        if m is not None and any(p.device != dev for p in m.parameters()):
            raise ValueError(f"{name} has parameters off {dev}")


def make_eval_step(model: nn.Module, bg_model: Optional[nn.Module], hparams,
                   render_cfg: RenderConfig, scene: SceneInfo, *,
                   mip: bool = False,
                   device=None) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """eval_step(batch) -> results dict, on ``device`` (default ``cuda``).

    batch: {"rays": [N, 8] (o, d, near, far), optional "image_indices": [N],
    with ``mip`` "radii": [N, 1]}, numpy arrays or tensors. The models must
    already live on the device. ``mip`` renders with ``render_rays_mip``
    (no background model; a cascade's coarse level, as in JAX),
    deterministically.
    """
    dev = resolve_device(device)
    _check_on(dev, model=model, bg_model=bg_model)
    center = _as_tensor(scene.sphere_center, dev)
    radius = _as_tensor(scene.sphere_radius, dev)
    model_fn, model_fn_fine = make_model_fn_pair(model)
    bg_fn, bg_fn_fine = make_model_fn_pair(bg_model)

    @torch.no_grad()
    def eval_step(batch) -> Dict[str, torch.Tensor]:
        rays = _as_tensor(batch["rays"], dev)
        image_indices = (_as_tensor(batch.get("image_indices"), dev)
                         if hparams.appearance_dim > 0 else None)
        if mip:
            return render_rays_mip(model_fn, rays,
                                   _as_tensor(batch["radii"], dev),
                                   image_indices, render_cfg, get_depth=True)
        return render_rays(model_fn, bg_fn, rays, image_indices, render_cfg,
                           center, radius, get_depth=True,
                           # fg/bg decomposition for the eval viz protocol
                           get_bg_fg_rgb=True, model_fn_fine=model_fn_fine,
                           bg_model_fn_fine=bg_fn_fine)
    return eval_step


# ------------------------------------------------------------- training ----

def lr_schedule(hparams) -> Callable[[int], float]:
    """The learning rate of optimizer step t (0-based), as the JAX package's
    ``optax.exponential_decay``: lr * gamma^(acc-1) * (gamma^acc)^t with
    gamma = lr_decay_factor ** (1 / train_iterations) and acc the
    accumulation steps. The reference steps its ExponentialLR every
    micro-iteration, so its update c lands after acc*c + acc - 1 decays
    (``switch_nerf_tpu/trainer.py:65-84``). Constant with
    --no_optimizer_schedulers."""
    lr = hparams.lr
    if getattr(hparams, "no_optimizer_schedulers", False):
        return lambda t: lr
    acc = getattr(hparams, "accumulation_steps", 1) or 1
    gamma = hparams.lr_decay_factor ** (1.0 / hparams.train_iterations)
    return lambda t: lr * gamma ** (acc - 1) * (gamma ** acc) ** t


def create_optimizer(hparams, params: List[nn.Parameter],
                     zero_dims: Optional[List[Optional[int]]] = None,
                     on: Optional[mesh.Mesh] = None) -> torch.optim.Adam:
    """Adam(betas (0.9, 0.999), eps 1e-8) over the fg and bg parameters
    together (Adam is per tensor, so one optimizer equals two). The step
    sets its learning rate from ``lr_schedule`` before every update.
    ZeRO-1 (`zero_dims`, one entry a parameter, on the mesh `on`): a
    ``ZeroAdam`` that keeps the moments of the leaves with a dimension
    for this rank's slice of it."""
    kw = dict(lr=lr_schedule(hparams)(0), betas=(0.9, 0.999), eps=1e-8)
    if zero_dims is not None and any(d is not None for d in zero_dims):
        return ZeroAdam(params, zero_dims, on, **kw)
    return torch.optim.Adam(params, **kw)


def _mse(pred, target):
    return torch.mean(torch.square(pred.float() - target.float()))


def _psnr(mse):
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def compute_losses(results: Dict[str, torch.Tensor], rgbs: torch.Tensor,
                   hparams, mip_or_cascade_coarse: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """The training metrics and loss (``switch_nerf_tpu/trainer.py:160-203``):
    photo MSE, psnr, depth variance, with ``mip_or_cascade_coarse`` the mean
    of the fine and coarse photo losses, and moe_l_aux_wt * the mean
    load-balance loss of the coarse and fine passes."""
    typ = "fine" if "rgb_fine" in results else "coarse"
    photo_loss = _mse(results[f"rgb_{typ}"], rgbs)
    metrics = {"psnr": _psnr(photo_loss), "photo_loss": photo_loss,
               "loss": photo_loss}
    if f"depth_variance_{typ}" in results:
        metrics["depth_variance"] = torch.mean(
            results[f"depth_variance_{typ}"])
    if mip_or_cascade_coarse and typ != "coarse":
        coarse_loss = _mse(results["rgb_coarse"], rgbs)
        metrics["coarse_loss"] = coarse_loss
        metrics["loss"] = (metrics["loss"] + coarse_loss) / 2.0

    use_moe = hparams.use_moe or getattr(hparams, "bg_use_moe", False)
    balance = use_moe and hparams.use_balance_loss
    if balance:
        gl = results.get(f"gate_loss_{typ}")
        if gl is not None and gl.numel():
            gate_loss = torch.mean(gl)
            glc = results.get("gate_loss_coarse")
            if typ == "fine" and glc is not None and glc.numel():
                gate_loss = (gate_loss + torch.mean(glc)) / 2.0
            metrics["gate_loss"] = gate_loss
        bgl = results.get(f"bg_gate_loss_{typ}")
        if (getattr(hparams, "bg_use_moe", False) and bgl is not None
                and bgl.numel()):
            bg_gate = torch.mean(bgl)
            bgc = results.get("bg_gate_loss_coarse")
            if typ == "fine" and bgc is not None and bgc.numel():
                bg_gate = (bg_gate + torch.mean(bgc)) / 2.0
            metrics["bg_gate_loss"] = bg_gate

    all_loss = metrics["loss"]
    if balance:
        for key in ("gate_loss", "bg_gate_loss"):
            if key in metrics:
                all_loss = all_loss + hparams.moe_l_aux_wt * metrics[key]
    metrics["all_loss"] = all_loss
    return metrics


@dataclasses.dataclass
class TrainState:
    """Everything one training step reads and updates.

    model / bg_model: the fg and bg modules, updated in place
    optimizer:        Adam over both (``create_optimizer``; ZeRO-1's
                      ``ZeroAdam`` under --shard_optimizer_states)
    generator:        the device generator every random draw of a step
                      comes from (``render/rendering.py`` gives the order)
    step:             finite micro-steps taken (the JAX state's ``step``)
    opt_step:         optimizer updates applied; indexes ``lr_schedule``
    mini_step:        micro-steps into the current accumulation window
    acc_grads:        the window's running mean gradient, as
                      ``optax.MultiSteps`` keeps it (acc > 1 only); each
                      shaped like its parameter (a rank's part under
                      expert or weight parallelism, whole under ZeRO-1)
    scheduled_lr:     whether the learning rate decays (off with
                      --no_optimizer_schedulers); the JAX optimizer state
                      then holds the schedule's count
    rng:              the JAX package's PRNG key (uint32[2]) from a loaded
                      checkpoint, carried opaquely (the port draws from
                      ``generator``); None when none was loaded
    """
    model: nn.Module
    bg_model: Optional[nn.Module]
    optimizer: torch.optim.Adam
    generator: torch.Generator
    step: int = 0
    opt_step: int = 0
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None
    scheduled_lr: bool = True
    rng: Optional[np.ndarray] = None

    def parameters(self) -> List[nn.Parameter]:
        params = list(self.model.parameters())
        if self.bg_model is not None:
            params += list(self.bg_model.parameters())
        return params


def create_train_state(hparams, model: nn.Module,
                       bg_model: Optional[nn.Module], *, device=None,
                       seed: Optional[int] = None) -> TrainState:
    """The optimizer over the models' parameters (with a zero accumulation
    window when --accumulation_steps > 1) and a generator on ``device``
    (default ``cuda``) seeded with ``seed`` (default --random_seed plus the
    process's rank): the state a training step updates, and the one
    eval loads a checkpoint into."""
    dev = resolve_device(device)
    _check_on(dev, model=model, bg_model=bg_model)
    params = list(model.parameters())
    if bg_model is not None:
        params += list(bg_model.parameters())
    # each rank of a data-parallel run draws its own perturbation and
    # noise: rank r's generator is seeded with --random_seed + r
    generator = torch.Generator(device=dev).manual_seed(
        hparams.random_seed + host.rank() if seed is None else seed)
    acc = getattr(hparams, "accumulation_steps", 1) or 1
    # --shard_optimizer_states: which leaves' moments are sliced
    on = mesh.current()
    dims = (bridge.zero_dims(bridge.model_leaves(model, bg_model), on,
                             hparams.moe_expert_num)
            if on is not None and on.zero else None)
    return TrainState(
        model=model, bg_model=bg_model,
        optimizer=create_optimizer(hparams, params, dims, on),
        generator=generator,
        acc_grads=[torch.zeros_like(p) for p in params] if acc > 1 else None,
        scheduled_lr=not getattr(hparams, "no_optimizer_schedulers", False))


def _mesh_of(p) -> Optional[mesh.Mesh]:
    return (getattr(p, "expert_mesh", None)
            or getattr(p, "weight_mesh", None))


def _rest(p) -> str:
    """The ranks a gradient of parameter `p` is still to be summed over:
    every one (``world``, a whole leaf), the ``data`` group (an
    expert-parallel block), the ``expert`` group (a weight-parallel
    column block, the same on the expert group's ranks without expert
    parallelism) or none (``""``: both cuts)."""
    experts_cut = getattr(p, "expert_mesh", None) is not None
    columns_cut = getattr(p, "weight_mesh", None) is not None
    if experts_cut:
        return "" if columns_cut else "data"
    return "expert" if columns_cut else "world"


class TrainStep:
    """train_step(state, batch) -> (state, metrics); see make_train_step."""

    def __init__(self, hparams, render_cfg: RenderConfig, scene: SceneInfo,
                 device, mip: bool = False):
        self.hparams = hparams
        self.render_cfg = render_cfg
        self.mip = mip
        self.device = resolve_device(device)
        self.center = _as_tensor(scene.sphere_center, self.device)
        self.radius = _as_tensor(scene.sphere_radius, self.device)
        self.check_finite = not getattr(hparams, "disable_check_finite",
                                        False)
        self.acc = getattr(hparams, "accumulation_steps", 1) or 1
        self.schedule = lr_schedule(hparams)

    def loss_and_grads(self, state: TrainState, batch
                       ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """Render the batch in train mode and differentiate all_loss with
        respect to ``state.parameters()``; updates nothing but the
        generator. Returns (metrics as detached 0-d tensors, grads)."""
        dev = self.device
        rays = _as_tensor(batch["rays"], dev)
        rgbs = _as_tensor(batch["rgbs"], dev)
        image_indices = (_as_tensor(batch.get("image_indices"), dev)
                         if self.hparams.appearance_dim > 0 else None)
        model_fn, model_fn_fine = make_model_fn_pair(state.model)
        bg_fn, bg_fn_fine = make_model_fn_pair(state.bg_model)
        # data parallel: the rays are this rank's share of the global
        # batch, whose model chunks are JAX's (parallel/chunks.py)
        world = host.world_size()
        grid = chunks.RankGrid(host.rank(), world) if world > 1 else None
        ep_mesh = experts.mesh_of(state.parameters())
        if ep_mesh is not None:
            experts.begin_pass()
        # weight parallel: the experts' column blocks gathered once a pass
        with torch.enable_grad(), hold_for_pass(state.model,
                                                state.bg_model):
            if self.mip:
                # a cascade's coarse level only, as in JAX
                results = render_rays_mip(
                    model_fn, rays,
                    _as_tensor(batch["radii"], dev), image_indices,
                    self.render_cfg, train=True, generator=state.generator,
                    get_depth_variance=True, grid=grid)
            else:
                results = render_rays(
                    model_fn, bg_fn, rays, image_indices,
                    self.render_cfg, self.center, self.radius, train=True,
                    generator=state.generator, get_depth_variance=True,
                    grid=grid, model_fn_fine=model_fn_fine,
                    bg_model_fn_fine=bg_fn_fine)
            metrics = compute_losses(
                results, rgbs, self.hparams,
                mip_or_cascade_coarse=self.mip or self.render_cfg.use_cascade)
            if ep_mesh is not None:
                # every rank of an expert group made the same exchanges,
                # so the backward's pair up
                experts.end_pass(ep_mesh)
            params = state.parameters()
            grads = torch.autograd.grad(metrics["all_loss"], params,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return {k: v.detach() for k, v in metrics.items()}, grads

    def average_across_ranks(self, metrics: Dict[str, torch.Tensor],
                             grads: Optional[List[torch.Tensor]],
                             state: Optional[TrainState] = None
                             ) -> Tuple[Dict[str, torch.Tensor],
                                        Optional[List[torch.Tensor]]]:
        """The metrics (and, unless None, the gradients) averaged over the
        ranks of a data-parallel run: one all_reduce(SUM) over a flat fp32
        buffer, then / world size. Each rank's loss is the mean over an
        equal share of the global batch, so this is the global mean
        gradient. psnr is recomputed from the averaged photo_loss (the
        global batch's MSE), not averaged. Every rank gets the same bits.
        One process: returned as they are.

        A gradient of a part of a leaf (``state``'s parameters tagged by
        ``models/experts.localize``) is already summed over some ranks:
        an expert-parallel block's over its expert group's tokens (the
        exchange's backward), a weight-parallel column block's over the
        data group (the reduce-scatter of ``parallel/weights``). It is
        summed over the rest of the ranks only (``_rest``), then divided
        by the world size as well."""
        world = host.world_size()
        if world == 1:
            return metrics, grads
        rest = ([_rest(p) for p in state.parameters()]
                if state is not None and grads is not None
                else ["world"] * len(grads or []))
        keys = [k for k in metrics if k != "psnr"]
        parts = [torch.stack([metrics[k].float() for k in keys])]
        if grads is not None:
            parts += [g.reshape(-1).float()
                      for g, r in zip(grads, rest) if r == "world"]
        flat = torch.cat(parts)
        dist.all_reduce(flat)
        flat /= world
        out = dict(zip(keys, flat[:len(keys)]))
        if "photo_loss" in out:
            out["psnr"] = _psnr(out["photo_loss"])
        if grads is not None:
            sums, lo = {"world": flat}, {"world": len(keys)}
            params = state.parameters() if state is not None else []
            for name in ("data", "expert", ""):
                mine = [(g, p) for g, p, r in zip(grads, params, rest)
                        if r == name]
                if not mine:
                    continue
                buf = torch.cat([g.reshape(-1).float() for g, _ in mine])
                on = _mesh_of(mine[0][1])
                if name and on.size(name) > 1:
                    dist.all_reduce(buf, group=(on.data_group
                                                if name == "data"
                                                else on.expert_group))
                buf /= world
                sums[name], lo[name] = buf, 0
            reduced = []
            for g, r in zip(grads, rest):
                reduced.append(sums[r][lo[r]:lo[r] + g.numel()].view_as(
                    g).to(g.dtype))
                lo[r] += g.numel()
            grads = reduced
        return {k: out[k] for k in metrics}, grads

    def _apply(self, state: TrainState, grads: List[torch.Tensor],
               applies: bool) -> None:
        """Adam on grads (at the micro-step that ``applies``, with acc > 1
        the window's mean gradient), or (acc > 1, any other micro-step)
        fold grads into the window's running mean, as optax.MultiSteps."""
        params = state.parameters()
        if not applies:
            n = state.mini_step
            for a, g in zip(state.acc_grads, grads):
                a.add_((g - a) / (n + 1))
            state.mini_step += 1
            state.step += 1
            return
        for p, g in zip(params, grads):
            p.grad = g
        for group in state.optimizer.param_groups:
            group["lr"] = self.schedule(state.opt_step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        if self.acc > 1:
            for a in state.acc_grads:
                a.zero_()
            state.mini_step = 0
        state.opt_step += 1
        state.step += 1

    def __call__(self, state: TrainState, batch
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        metrics, grads = self.loss_and_grads(state, batch)
        applies = state.mini_step == self.acc - 1
        if self.acc > 1 and applies:
            # the window's mean gradient with this micro-step folded in
            n = state.mini_step
            grads = [a + (g - a) / (n + 1)
                     for a, g in zip(state.acc_grads, grads)]
        # data parallel: the gradient that updates is averaged over the
        # ranks, and every rank votes on the same averaged metrics, so a
        # non-finite value on one rank skips the step on all of them
        metrics, reduced = self.average_across_ranks(
            metrics, grads if applies else None, state)
        if applies:
            grads = reduced
        if self.check_finite:
            # skip the update on a non-finite metric (psnr = inf, a perfect
            # fit, excluded), leaving parameters, optimizer, schedule and
            # step alone, and discard the accumulation window, as the JAX
            # step's lax.cond and _reset_multisteps do
            finite = bool(torch.stack(
                [torch.isfinite(v).all() for k, v in metrics.items()
                 if k != "psnr"]).all())
            metrics["finite"] = torch.tensor(float(finite),
                                             device=self.device)
            if not finite:
                state.mini_step = 0
                if state.acc_grads is not None:
                    for a in state.acc_grads:
                        a.zero_()
                return state, metrics
        self._apply(state, grads, applies)
        return state, metrics


def make_train_step(hparams, render_cfg: RenderConfig, scene: SceneInfo, *,
                    mip: bool = False, device=None) -> TrainStep:
    """Build train_step(state, batch) -> (state, metrics) on ``device``
    (default ``cuda``), the port of ``switch_nerf_tpu/trainer.py:222-287``.

    batch: {"rays": [B, 8], "rgbs": [B, 3], optional "image_indices": [B],
    with ``mip`` "radii": [B, 1]}, numpy arrays or tensors. One call renders the batch in train mode
    (perturbation, sigma noise, random fine samples from the state's
    generator), differentiates ``all_loss`` through the hand-written
    kernels' backwards, and applies Adam with the scheduled learning rate.
    ``train_step.loss_and_grads`` gives the metrics and gradients without
    the update.
    """
    return TrainStep(hparams, render_cfg, scene, device, mip)
