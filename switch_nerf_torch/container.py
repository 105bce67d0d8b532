"""Self-contained inference artifact ("container") export and load.

Port of ``switch_nerf_tpu/container.py``, in the same directory format, so
a container either package writes loads in the other:

    container/
      model_config.json    everything needed to rebuild the models (the
                           layer graph, flags, appearance count, scene
                           geometry): the _MODEL_KEYS of the hparams
      params.msgpack       the parameters {"nerf": ... [, "bg_nerf": ...]}
                           as flax serializes them (``_msgpack.py``), in
                           the JAX package's layout (``bridge.py``)

``load_container`` rebuilds the port's modules on a device and loads the
parameters into them: no optimizer state, no training flags.
"""
from __future__ import annotations

import json
from argparse import Namespace
from pathlib import Path
from typing import Optional, Tuple

from torch import nn

from switch_nerf_torch import _msgpack, bridge

_MODEL_KEYS = [
    "use_moe", "bg_use_moe", "bg_use_cfg", "moe_expert_num",
    "moe_capacity_factor", "model", "model_bg", "pos_xyz_dim", "pos_dir_dim",
    "layers", "skip_layers", "layer_dim", "bg_layer_dim", "appearance_dim",
    "affine_appearance", "use_cascade", "sh_deg", "shifted_softplus",
    "use_mip", "nerfmoe_class_name", "batch_prioritized_routing",
    "gate_noise", "use_load_importance_loss", "compute_balance_loss",
    "dispatcher_no_score", "dispatcher_no_postscore",
    "use_moe_external_gate", "use_gate_input_norm", "moe_use_residual",
    "moe_return_gates", "moe_return_gate_logits", "moe_train_batch",
    "moe_test_batch", "amp", "amp_use_bfloat16", "bg_nerf", "fine_samples",
    "no_expert_parallel", "container_path", "train_mega_nerf",
]


def save_container(path, hparams, model: nn.Module,
                   bg_model: Optional[nn.Module], appearance_count: int,
                   scene: Optional[dict] = None) -> Path:
    """Write `model` (and `bg_model`) with the hparams' model keys."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    cfg = {k: getattr(hparams, k, None) for k in _MODEL_KEYS}
    cfg["appearance_count"] = appearance_count
    cfg["scene"] = scene or {}
    (path / "model_config.json").write_text(json.dumps(cfg, indent=1))
    (path / "params.msgpack").write_bytes(
        _msgpack.packb(bridge.export_jax_state(model, bg_model)))
    return path


def load_container(path, device=None
                   ) -> Tuple[nn.Module, Optional[nn.Module], dict]:
    """(model, background model or None, config) on ``device`` (default
    ``cuda``)."""
    from switch_nerf_torch.models.model_utils import get_bg_nerf, get_nerf

    path = Path(path)
    if not (path / "model_config.json").exists():
        raise FileNotFoundError(f"{path}: no model_config.json (not a "
                                "container directory)")
    cfg = json.loads((path / "model_config.json").read_text())
    # the initial draws are overwritten: any seed builds the modules
    h = Namespace(random_seed=0, **{k: v for k, v in cfg.items()
                                    if k not in ("appearance_count", "scene")})
    count = cfg["appearance_count"]
    model = get_nerf(h, count, device=device)
    bg = (get_bg_nerf(h, count, device=device)
          if getattr(h, "bg_nerf", False) else None)
    bridge.load_jax_state(model, bg, _msgpack.unpackb(
        (path / "params.msgpack").read_bytes()))
    return model, bg, cfg
