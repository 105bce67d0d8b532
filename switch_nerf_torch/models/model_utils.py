"""Model factories: hparams -> nn.Module on the chosen device.

Port of ``switch_nerf_tpu/models/model_utils.py``: ``get_nerf`` builds the
NeRFMoE or, with --use_mip or --nerfmoe_class_name MipNeRFMoE, the
MipNeRFMoE (``--use_moe``), or the dense NeRF (which, as in JAX, ignores
mip: a mip renderer's 6-wide input then raises); ``get_bg_nerf`` the
background NeRF (4-wide xyz): dense, or with --bg_use_cfg --bg_use_moe a
NeRFMoE of the --model_bg graph. With --use_cascade each is a
``Cascade`` of a coarse and a fine model (no fine one with --fine_samples
0). --sh_deg widens the colour heads to its SH coefficients. Weights are
drawn from a ``torch.Generator`` seeded with ``seed`` (default
``--random_seed``) on the CPU, then moved to the device. Under expert
or expert weight parallelism (``parallel.mesh.current()``) the MoE layers
then keep this rank's part of the experts (``models/experts.localize``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from switch_nerf_torch import resolve_device
from switch_nerf_torch.models.cascade import Cascade
from switch_nerf_torch.models.experts import localize
from switch_nerf_torch.models.nerf import NeRF
from switch_nerf_torch.models.nerf_moe import NeRFMoE
from switch_nerf_torch.parallel import mesh

__all__ = ["get_nerf", "get_bg_nerf", "eval_dispatch", "use_mip"]


def _compute_dtype(hparams) -> torch.dtype:
    """bf16 "AMP": --amp means bf16 compute with fp32 params/gate/sigma."""
    return torch.bfloat16 if getattr(hparams, "amp", False) else torch.float32


def _dispatch_mode(hparams, batch_flag: bool) -> str:
    """Dispatch mode for one phase, as the JAX package resolves it:
    --apply_on_expert_fn_name (when set) overrides moe_{train,test}_batch."""
    table = {"apply_on_expert_fn": "padded",
             "apply_on_expert_fn_nobatch": "nodrop",
             "apply_on_expert_fn_nobatch_torch": "nodrop"}
    name = getattr(hparams, "apply_on_expert_fn_name", None)
    if name is not None:
        if name not in table:
            raise ValueError(f"--apply_on_expert_fn_name {name!r} unknown; "
                             f"expected one of {sorted(table)}")
        return table[name]
    return "padded" if batch_flag else "nodrop"


def eval_dispatch(hparams) -> str:
    """The MoE layers' eval dispatch mode: 'padded' (--moe_test_batch) or
    'nodrop'."""
    return _dispatch_mode(hparams, hparams.moe_test_batch)


def _rgb_dim(hparams) -> int:
    """3, or with --sh_deg the 3 * (deg + 1)^2 SH coefficients."""
    if hparams.sh_deg is not None:
        return 3 * (hparams.sh_deg + 1) ** 2
    return 3


def use_mip(hparams) -> bool:
    """Mip-ness as the JAX package decides it: --use_mip or the MipNeRFMoE
    class name."""
    class_name = getattr(hparams, "nerfmoe_class_name", "NeRFMoE") or "NeRFMoE"
    return class_name == "MipNeRFMoE" or bool(getattr(hparams, "use_mip",
                                                      False))


def _get_nerf_moe(hparams, appearance_count: int, generator,
                  xyz_dim: int = 3, cfg_name: str = "model") -> nn.Module:
    layer_cfg = getattr(hparams, cfg_name)
    if layer_cfg is None:
        raise ValueError(f"--{cfg_name} layer graph required")
    layer_cfg = dict(layer_cfg)
    layer_cfg.setdefault("expert_num", hparams.moe_expert_num)
    return NeRFMoE(
        layer_cfg=layer_cfg,
        pos_xyz_dim=hparams.pos_xyz_dim,
        pos_dir_dim=hparams.pos_dir_dim,
        appearance_dim=hparams.appearance_dim,
        affine_appearance=hparams.affine_appearance,
        appearance_count=appearance_count,
        rgb_dim=_rgb_dim(hparams),
        xyz_dim=xyz_dim,
        shifted_softplus_sigma=hparams.shifted_softplus,
        use_mip=use_mip(hparams),
        moe_capacity_factor=hparams.moe_capacity_factor,
        batch_prioritized_routing=hparams.batch_prioritized_routing,
        dispatcher_no_score=hparams.dispatcher_no_score,
        is_postscore=not hparams.dispatcher_no_postscore,
        use_moe_external_gate=hparams.use_moe_external_gate,
        use_gate_input_norm=hparams.use_gate_input_norm,
        moe_return_gates=hparams.moe_return_gates,
        gate_noise=hparams.gate_noise,
        use_load_importance_loss=hparams.use_load_importance_loss,
        compute_balance_loss=hparams.compute_balance_loss,
        moe_use_residual=hparams.moe_use_residual,
        moe_return_gate_logits=hparams.moe_return_gate_logits,
        moe_expert_type=getattr(hparams, "moe_expert_type", "expertmlp"),
        train_dispatch=_dispatch_mode(hparams, hparams.moe_train_batch),
        eval_dispatch=eval_dispatch(hparams),
        sigma_fp32=not getattr(hparams, "amp_use_bfloat16", False),
        compute_dtype=_compute_dtype(hparams),
        generator=generator)


def _get_dense_nerf(hparams, appearance_count: int, layer_dim: int,
                    xyz_dim: int, generator) -> nn.Module:
    return NeRF(
        pos_xyz_dim=hparams.pos_xyz_dim,
        pos_dir_dim=hparams.pos_dir_dim,
        layers=hparams.layers,
        skip_layers=tuple(hparams.skip_layers),
        layer_dim=layer_dim,
        appearance_dim=hparams.appearance_dim,
        affine_appearance=hparams.affine_appearance,
        appearance_count=appearance_count,
        rgb_dim=_rgb_dim(hparams),
        xyz_dim=xyz_dim,
        shifted_softplus_sigma=hparams.shifted_softplus,
        compute_dtype=_compute_dtype(hparams),
        generator=generator)


def _generator(hparams, seed: Optional[int]) -> torch.Generator:
    return torch.Generator().manual_seed(
        hparams.random_seed if seed is None else seed)


def _build(hparams, appearance_count: int, gen, moe: bool, layer_dim: int,
           xyz_dim: int, cfg_name: str) -> nn.Module:
    """One model, or with --use_cascade the coarse/fine pair, drawn from
    `gen` (the coarse level first)."""
    def one():
        if moe:
            return _get_nerf_moe(hparams, appearance_count, gen, xyz_dim,
                                 cfg_name)
        return _get_dense_nerf(hparams, appearance_count, layer_dim, xyz_dim,
                               gen)
    if getattr(hparams, "use_cascade", False):
        coarse = one()
        return Cascade(coarse, one() if hparams.fine_samples > 0 else None)
    return one()


def _place(model: nn.Module, device, moe: bool) -> nn.Module:
    model = model.to(resolve_device(device)).eval()
    # expert (weight) parallelism: the whole model is drawn (so every rank
    # draws the data-parallel weights), then each rank keeps its part of
    # the experts
    on = mesh.current()
    if on is not None and moe:
        localize(model, on)
    return model


def get_nerf(hparams, appearance_count: int, *, device=None,
             seed: Optional[int] = None) -> nn.Module:
    """Foreground model on ``device`` (default ``cuda``). Train or eval
    behaviour is chosen per call (``model(x, sigma_noise, train)``)."""
    moe = bool(getattr(hparams, "use_moe", False))
    model = _build(hparams, appearance_count, _generator(hparams, seed), moe,
                   hparams.layer_dim, 3, "model")
    return _place(model, device, moe)


def get_bg_nerf(hparams, appearance_count: int, *, device=None,
                seed: Optional[int] = None) -> nn.Module:
    """Background (inverted-sphere) NeRF: 4-dim xyz input (x', y', z', 1/r).

    Dense (--bg_layer_dim wide) unless --bg_use_cfg with --bg_use_moe,
    which builds a NeRFMoE of the --model_bg graph (JAX
    ``model_utils.py:153-167``). Seeded with ``seed`` (default
    --random_seed + 1).
    """
    moe = bool(getattr(hparams, "bg_use_cfg", False) and hparams.bg_use_moe)
    gen = _generator(hparams,
                     hparams.random_seed + 1 if seed is None else seed)
    model = _build(hparams, appearance_count, gen, moe, hparams.bg_layer_dim,
                   4, "model_bg")
    return _place(model, device, moe)
