"""Model factories: hparams -> nn.Module on the chosen device.

Port of ``switch_nerf_tpu/models/model_utils.py`` for the non-cascade
configs: ``get_nerf`` builds the NeRFMoE or, with --use_mip or
--nerfmoe_class_name MipNeRFMoE, the MipNeRFMoE (``--use_moe``), or the
dense NeRF; ``get_bg_nerf`` the dense background NeRF. Weights are drawn
from a ``torch.Generator`` seeded with ``seed`` (default
``--random_seed``) on the CPU, then moved to the device. Under expert
parallelism (``parallel.mesh.current()``) the MoE layers then keep this
rank's block of experts (``models/experts.localize``).
"""
from __future__ import annotations

from argparse import Namespace
from typing import Optional

import torch
from torch import nn

from switch_nerf_torch import resolve_device
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
    if hparams.sh_deg is not None:
        raise NotImplementedError(
            "spherical-harmonics color waits for a later slice of the port")
    return 3


def use_mip(hparams) -> bool:
    """Mip-ness as the JAX package decides it: --use_mip or the MipNeRFMoE
    class name."""
    class_name = getattr(hparams, "nerfmoe_class_name", "NeRFMoE") or "NeRFMoE"
    return class_name == "MipNeRFMoE" or bool(getattr(hparams, "use_mip",
                                                      False))


def _check_supported(hparams) -> None:
    for flag, on in (("use_cascade", hparams.use_cascade),
                     ("affine_appearance", hparams.affine_appearance)):
        if on:
            raise NotImplementedError(
                f"--{flag} waits for a later slice of the port")
    if use_mip(hparams) and not getattr(hparams, "use_moe", False):
        raise NotImplementedError(
            "a dense mip NeRF waits for a later slice of the port")


def _get_nerf_moe(hparams, appearance_count: int, generator) -> nn.Module:
    layer_cfg = dict(hparams.model)
    layer_cfg.setdefault("expert_num", hparams.moe_expert_num)
    # gate noise raises when a train state is built
    # (MoELayer.check_supported)
    if (hparams.moe_use_residual or hparams.use_load_importance_loss
            or getattr(hparams, "moe_expert_type", "expertmlp") != "expertmlp"):
        raise NotImplementedError(
            "residual MoE, the load-importance loss and ffn experts wait for "
            "a later slice of the port")
    return NeRFMoE(
        layer_cfg=layer_cfg,
        pos_xyz_dim=hparams.pos_xyz_dim,
        pos_dir_dim=hparams.pos_dir_dim,
        appearance_dim=hparams.appearance_dim,
        appearance_count=appearance_count,
        rgb_dim=_rgb_dim(hparams),
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
        appearance_count=appearance_count,
        rgb_dim=_rgb_dim(hparams),
        xyz_dim=xyz_dim,
        shifted_softplus_sigma=hparams.shifted_softplus,
        compute_dtype=_compute_dtype(hparams),
        generator=generator)


def _generator(hparams, seed: Optional[int]) -> torch.Generator:
    return torch.Generator().manual_seed(
        hparams.random_seed if seed is None else seed)


def get_nerf(hparams, appearance_count: int, *, device=None,
             seed: Optional[int] = None) -> nn.Module:
    """Foreground model on ``device`` (default ``cuda``). Train or eval
    behaviour is chosen per call (``model(x, sigma_noise, train)``)."""
    dev = resolve_device(device)
    _check_supported(hparams)
    gen = _generator(hparams, seed)
    if getattr(hparams, "use_moe", False):
        model = _get_nerf_moe(hparams, appearance_count, gen)
    else:
        model = _get_dense_nerf(hparams, appearance_count, hparams.layer_dim,
                                3, gen)
    model = model.to(dev).eval()
    # expert parallelism: the whole model is drawn (so every rank draws the
    # data-parallel weights), then each rank keeps its block of experts
    ep = mesh.current()
    if (ep is not None and getattr(hparams, "use_moe", False)
            and not getattr(hparams, "no_expert_parallel", True)):
        localize(model, ep)
    return model


def get_bg_nerf(hparams, appearance_count: int, *, device=None,
                seed: Optional[int] = None) -> nn.Module:
    """Background (inverted-sphere) NeRF: 4-dim xyz input (x', y', z', 1/r).

    Dense unless --bg_use_cfg with --bg_use_moe, which waits for a later
    slice. Seeded with ``seed`` (default ``--random_seed + 1``).
    """
    dev = resolve_device(device)
    _check_supported(hparams)
    if getattr(hparams, "bg_use_cfg", False) and hparams.bg_use_moe:
        raise NotImplementedError("an MoE background waits for a later slice")
    sub = Namespace(**vars(hparams))
    sub.use_moe = False
    gen = _generator(hparams, hparams.random_seed + 1 if seed is None else seed)
    model = _get_dense_nerf(sub, appearance_count, hparams.bg_layer_dim, 4,
                            gen)
    return model.to(dev).eval()
