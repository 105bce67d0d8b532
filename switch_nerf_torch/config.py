"""Config + flag system of the PyTorch port: the same flags, defaults and
YAML handling as ``switch_nerf_tpu/config.py``, kept as a copy so that the
port imports nothing of the JAX package.

Parity targets:
  * switch_nerf/opts.py:5-271        — get_opts_base / get_opts (mega/block path)
  * switch_nerf/opts_nerf.py:5-308   — classic-NeRF flags + get_nerf_dataset_args

The reference uses configargparse's YAMLConfigFileParser (CLI overrides YAML).
configargparse is not in this image, so we implement the same precedence with
plain argparse: YAML values are applied as defaults before parsing, so any
explicitly-passed CLI flag wins. The `--model` / `--model_bg` flags are
YAML-typed nested dicts defining the network layer graph
(opts.py:121-124), consumed by models/nerf_moe.py.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import yaml


def _yaml_load(s):
    if isinstance(s, (dict, list)):
        return s
    return yaml.safe_load(s)


def get_opts_base() -> argparse.ArgumentParser:
    """Flag superset shared by all entry points (opts.py:5-271)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--config_file", type=str, default=None,
                   help="YAML config; CLI flags override its values")

    # data
    p.add_argument("--dataset_type", type=str, default="filesystem",
                   choices=["filesystem", "memory"])
    p.add_argument("--chunk_paths", type=str, nargs="+", default=None)
    p.add_argument("--num_chunks", type=int, default=200)
    p.add_argument("--generate_chunk", default=False, action="store_true")
    p.add_argument("--disk_flush_size", type=int, default=10000000)
    p.add_argument("--train_every", type=int, default=1)
    p.add_argument("--cluster_mask_path", type=str, default=None)
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--container_path", type=str, default=None)

    # ray bounds / sampling
    p.add_argument("--near", type=float, default=1)
    p.add_argument("--far", type=float, default=None)
    p.add_argument("--ray_altitude_range", nargs="+", type=float, default=None)
    p.add_argument("--coarse_samples", type=int, default=256)
    p.add_argument("--fine_samples", type=int, default=512)
    p.add_argument("--train_scale_factor", type=int, default=1)
    p.add_argument("--val_scale_factor", type=int, default=4)

    # model architecture (dense path)
    p.add_argument("--pos_xyz_dim", type=int, default=12)
    p.add_argument("--pos_dir_dim", type=int, default=4)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--skip_layers", type=int, nargs="+", default=[4])
    p.add_argument("--layer_dim", type=int, default=256)
    p.add_argument("--bg_layer_dim", type=int, default=256)
    p.add_argument("--appearance_dim", type=int, default=48)
    p.add_argument("--affine_appearance", default=False, action="store_true")
    p.add_argument("--use_cascade", default=False, action="store_true")
    p.add_argument("--train_mega_nerf", type=str, default=None)
    p.add_argument("--boundary_margin", type=float, default=1.15)
    p.add_argument("--all_val", default=False, action="store_true")
    p.add_argument("--cluster_2d", default=False, action="store_true")
    p.add_argument("--sh_deg", type=int, default=None)
    p.add_argument("--no_center_pixels", dest="center_pixels",
                   default=True, action="store_false")
    p.add_argument("--no_shifted_softplus", dest="shifted_softplus",
                   default=True, action="store_false")

    # batching
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--image_pixel_batch_size", type=int, default=64 * 1024)
    p.add_argument("--model_chunk_size", type=int, default=32 * 1024)
    p.add_argument("--bg_model_chunk_size", type=int, default=None,
                   help="chunk size for the dense background pass "
                        "(defaults to model_chunk_size; larger is usually "
                        "faster since the bg model has no routing)")
    p.add_argument("--perturb", type=float, default=1.0)
    # inert in the reference too (only --sigma_noise_std is read,
    # rendering.py:326) — identical inertness is the parity
    p.add_argument("--noise_std", type=float, default=1.0)

    # optimisation
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr_decay_factor", type=float, default=0.1)
    p.add_argument("--no_bg_nerf", dest="bg_nerf", default=True,
                   action="store_false")
    p.add_argument("--ellipse_scale_factor", type=float, default=1.1)
    p.add_argument("--no_ellipse_bounds", dest="ellipse_bounds", default=True,
                   action="store_false")
    p.add_argument("--train_iterations", type=int, default=500000)
    p.add_argument("--val_interval", type=int, default=500001)
    p.add_argument("--ckpt_interval", type=int, default=10000)
    # retention: keep the newest N periodic checkpoints (0 = keep all, the
    # reference's behavior). 500k-iteration runs at ckpt_interval 10000
    # accumulate ~50 full checkpoints without this.
    p.add_argument("--ckpt_keep", type=int, default=0)
    p.add_argument("--no_resume_ckpt_state", dest="resume_ckpt_state",
                   default=True, action="store_false")
    p.add_argument("--no_amp", dest="amp", default=True, action="store_false")
    p.add_argument("--detect_anomalies", default=False, action="store_true")
    p.add_argument("--random_seed", type=int, default=42)

    # moe
    p.add_argument("--use_moe", default=False, action="store_true")
    p.add_argument("--bg_use_moe", default=False, action="store_true")
    p.add_argument("--bg_use_cfg", default=False, action="store_true")
    p.add_argument("--moe_expert_num", type=int, default=8)
    p.add_argument("--moe_l_aux_wt", type=float, default=1e-2)
    p.add_argument("--moe_capacity_factor", type=float, default=1.25)
    p.add_argument("--model", type=_yaml_load, default=None)
    p.add_argument("--model_bg", type=_yaml_load, default=None)
    p.add_argument("--expert_parallel", dest="no_expert_parallel",
                   default=True, action="store_false",
                   help="shard experts over the mesh 'expert' axis "
                        "(reference: --no_expert_parallel default True)")
    p.add_argument("--no_expert_parallel", default=True, action="store_true")
    p.add_argument("--shard_optimizer_states", default=False,
                   action="store_true",
                   help="ZeRO-1: each rank keeps Adam's moments of the "
                        "otherwise whole leaves for its slice of their first "
                        "dimension over the 'data' mesh axis "
                        "(numerics-invariant). Expert moments always follow "
                        "the expert sharding.")
    p.add_argument("--expert_weight_parallel", default=False,
                   action="store_true",
                   help="additionally shard expert weight matrices' hidden "
                        "(output) dim over the 'data' mesh axis, gathered "
                        "once a training step (the reference's ZeRO-style "
                        "zero_gather/PrimAllgather slicing, "
                        "tutel_moe_layer_nobatch.py:484-498; use when "
                        "experts are fewer than GPUs)")
    p.add_argument("--use_balance_loss", default=True, action="store_true")
    p.add_argument("--no_use_balance_loss", dest="use_balance_loss",
                   default=True, action="store_false")
    p.add_argument("--i_print", type=int, default=100)
    p.add_argument("--profile_trace_step", type=int, default=None,
                   help="trace 3 steps from this iteration with "
                        "torch.profiler (host, CUDA kernels and the "
                        "program's snerf.* spans) into a Chrome trace under "
                        "<exp>/profile")
    p.add_argument("--find_unused_parameters", default=False,
                   action="store_true")
    p.add_argument("--moe_use_residual", default=False, action="store_true")
    p.add_argument("--moe_expert_type", type=str, default="expertmlp")
    p.add_argument("--moe_train_batch", default=False, action="store_true")
    p.add_argument("--moe_test_batch", default=False, action="store_true")
    p.add_argument("--nerfmoe_class_name", type=str, default="NeRFMoE")
    p.add_argument("--use_slurm", action="store_true", default=False)
    p.add_argument("--accumulation_steps", type=int, default=1)
    p.add_argument("--expertmlp2seqexperts", action="store_true", default=False)
    p.add_argument("--batch_prioritized_routing", action="store_true",
                   default=False)
    p.add_argument("--no_batch_prioritized_routing",
                   dest="batch_prioritized_routing", action="store_false")

    # gates / point-cloud eval
    p.add_argument("--moe_return_gates", default=False, action="store_true")
    p.add_argument("--return_pts", action="store_true", default=False)
    p.add_argument("--return_pts_rgb", action="store_true", default=False)
    p.add_argument("--return_pts_alpha", action="store_true", default=False)
    p.add_argument("--render_test_points_typ", type=str, nargs="+",
                   default=["coarse"])
    p.add_argument("--render_test_points_sample_skip", type=int, default=1)
    p.add_argument("--render_test_points_image_num", type=int, default=1)
    p.add_argument("--return_pts_class_seg", default=False, action="store_true")
    p.add_argument("--moe_return_gate_logits", default=False,
                   action="store_true")
    p.add_argument("--shuffle_chunk", action="store_true", default=False)
    p.add_argument("--use_moe_external_gate", action="store_true",
                   default=False)
    p.add_argument("--use_gate_input_norm", action="store_true", default=False)

    # block nerf
    p.add_argument("--data_type", type=str, default="mega_nerf")
    p.add_argument("--block_train_list_path", type=str,
                   default="switch_nerf_tpu/datasets/lists/block_nerf_train.txt")
    p.add_argument("--block_val_list_path", type=str,
                   default="switch_nerf_tpu/datasets/lists/block_nerf_val.txt")
    p.add_argument("--block_image_hash_id_map_path", type=str,
                   default="switch_nerf_tpu/datasets/lists/block_nerf_id_map.json")
    # inert in the reference too (the runner plumbs --shuffle_chunk
    # only, runner.py:525-530)
    p.add_argument("--shuffle_tfrecord", action="store_true", default=True)

    p.add_argument("--amp_use_bfloat16", action="store_true", default=False)
    p.add_argument("--gate_noise", type=float, default=-1.0)
    p.add_argument("--use_load_importance_loss", action="store_true",
                   default=False)
    p.add_argument("--compute_balance_loss", action="store_true", default=False)
    p.add_argument("--dispatcher_no_score", action="store_true", default=False)
    p.add_argument("--dispatcher_no_postscore", action="store_true",
                   default=False)
    p.add_argument("--use_sigma_noise", action="store_true", default=False)
    p.add_argument("--sigma_noise_std", type=float, default=1.0)
    p.add_argument("--no_optimizer_schedulers", action="store_true",
                   default=False)
    p.add_argument("--data_loader_num_workers", type=int, default=1)
    p.add_argument("--disable_check_finite", action="store_true", default=False)
    p.add_argument("--compute_memory", action="store_true", default=False)
    p.add_argument("--white_bkgd", action="store_true", default=False)
    p.add_argument("--render_image_fn_name", type=str, default=None)

    # mip-nerf
    p.add_argument("--use_mip", default=False, action="store_true")
    p.add_argument("--weights_resample_padding", type=float, default=0.01)
    p.add_argument("--stop_level_grad", default=True, action="store_true")
    p.add_argument("--rgb_padding", type=float, default=0.001)

    p.add_argument("--training_step_fn", type=str, default=None)
    p.add_argument("--moe_layer_num", type=int, default=1)
    p.add_argument("--set_timeout", default=False, action="store_true")
    p.add_argument("--apply_on_expert_fn_name", type=str, default=None)
    p.add_argument("--return_sigma", default=False, action="store_true")
    p.add_argument("--return_alpha", default=False, action="store_true")
    p.add_argument("--moe_layer_ids", type=str, nargs="+", default=None)
    p.add_argument("--use_random_background_color", default=False,
                   action="store_true")

    # --- TPU-native additions (no reference analog) ---
    p.add_argument("--mesh_shape", type=int, nargs="+", default=None,
                   help="(data, expert) mesh shape; default = all devices on "
                        "the data axis")
    p.add_argument("--param_dtype", type=str, default="float32")
    p.add_argument("--remat", default=True, action="store_true")
    p.add_argument("--no_remat", dest="remat", action="store_false")
    return p


def get_opts() -> argparse.ArgumentParser:
    """Training/eval entry parser (opts.py get_opts analog)."""
    base = get_opts_base()
    p = argparse.ArgumentParser(parents=[base])
    p.add_argument("--exp_name", type=str, required=True,
                   help="experiment name")
    p.add_argument("--dataset_path", type=str, required=True)
    return p


def get_opts_nerf() -> argparse.ArgumentParser:
    """Classic-NeRF path flags (opts_nerf.py:5-308): llff/blender/bungee.

    The classic path extends `dataset_type` itself (opts_nerf.py:9-10) rather
    than adding a separate data-kind flag.
    """
    base = get_opts_base()
    p = argparse.ArgumentParser(parents=[base], conflict_handler="resolve")
    p.add_argument("--dataset_type", type=str, default="filesystem",
                   choices=["filesystem", "memory", "blender", "llff",
                            "bungee", "LINEMOD", "deepvoxels"])
    p.add_argument("--exp_name", type=str, required=True)
    p.add_argument("--dataset_path", type=str, required=True)
    # inert in the reference too (parsed at opts_nerf.py:25, never read)
    p.add_argument("--grid_id", type=int, default=None)
    p.add_argument("--shape", type=str, default="cube",
                   help="deepvoxels scene name")
    p.add_argument("--scale_factor", type=int, default=1,
                   help="downsamples all images if greater than 1")
    p.add_argument("--llff_factor", type=int, default=1)
    p.add_argument("--spheric_poses", default=False, action="store_true")
    p.add_argument("--no_ndc", action="store_true", default=False)
    p.add_argument("--testskip", type=int, default=8)
    p.add_argument("--bungee_ray_nearfar", type=str, default="sphere")
    p.add_argument("--llffhold", type=int, default=8)
    p.add_argument("--num_epochs", type=int, default=10000)
    p.add_argument("--colormap", type=int, default=4)
    return p


def _apply_yaml_defaults(parser: argparse.ArgumentParser,
                         argv: Sequence[str]) -> Sequence[str]:
    """Pre-scan argv for --config_file and fold YAML values into parser
    defaults so explicit CLI flags keep precedence (configargparse
    semantics)."""
    cfg_path = None
    argv = list(argv)
    for i, a in enumerate(argv):
        if a == "--config_file" and i + 1 < len(argv):
            cfg_path = argv[i + 1]
        elif a.startswith("--config_file="):
            cfg_path = a.split("=", 1)[1]
    if cfg_path is None:
        return argv
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f) or {}
    # configargparse matches YAML keys against *option strings* (so
    # `no_bg_nerf: True` acts like passing --no_bg_nerf, flipping dest
    # `bg_nerf` to False), falling back to dest names.
    by_opt = {}
    for a in parser._actions:
        for opt in a.option_strings:
            by_opt[opt.lstrip("-")] = a
    by_dest = {a.dest: a for a in parser._actions}
    defaults = {}
    for key, val in cfg.items():
        action = by_opt.get(key) or by_dest.get(key)
        if action is None:
            raise ValueError(f"unknown config key in {cfg_path}: {key!r}")
        if isinstance(action, (argparse._StoreTrueAction,
                               argparse._StoreFalseAction)):
            if val:
                defaults[action.dest] = action.const
            continue
        if action.nargs in ("+", "*") and not isinstance(val, (list, tuple)):
            # configargparse re-tokenizes scalars for list options — a
            # YAML `chunk_paths: /data/c` must become ['/data/c'], not a
            # string that later iterates character-by-character
            val = [val]
        if action.type is not None:
            if isinstance(val, (list, tuple)):
                val = [action.type(v) if isinstance(v, str) else v
                       for v in val]
            elif isinstance(val, str):
                val = action.type(val)
        # argparse validates `choices` only for command-line tokens, never
        # for defaults — enforce it here so a typo'd YAML value fails at
        # parse time naming the key, not deep inside the runner
        if action.choices is not None:
            vals = val if isinstance(val, (list, tuple)) else [val]
            for v in vals:
                if v not in action.choices:
                    raise ValueError(
                        f"config key {key!r} in {cfg_path}: invalid value "
                        f"{v!r} (choose from {sorted(action.choices)})")
        defaults[action.dest] = val
    parser.set_defaults(**defaults)
    # a value supplied by the YAML satisfies a `required` option
    # (configargparse semantics: config-file values count)
    for a in parser._actions:
        if getattr(a, "required", False) and a.dest in defaults:
            a.required = False
    return argv


def parse_args(parser: argparse.ArgumentParser,
               argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parse with YAML-config default folding. CLI > YAML > code default."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    # _apply_yaml_defaults mutates the parser in two ways: it flips
    # `required` off for options the YAML satisfies, and set_defaults()
    # overwrites action defaults with the YAML values. Restore BOTH
    # afterwards, or a reused parser instance silently leaks this
    # parse's config values (and loses required-enforcement) into a
    # later config-less parse
    was_required = [(a, a.required) for a in parser._actions
                    if getattr(a, "required", False)]
    prev_defaults = [(a, a.default) for a in parser._actions]
    prev_default_map = dict(parser._defaults)
    argv = _apply_yaml_defaults(parser, argv)
    try:
        hparams = parser.parse_args(argv)
    finally:
        for a, req in was_required:
            a.required = req
        for a, d in prev_defaults:
            a.default = d
        parser._defaults.clear()
        parser._defaults.update(prev_default_map)
    if hparams.model is not None and isinstance(hparams.model, str):
        hparams.model = yaml.safe_load(hparams.model)
    if getattr(hparams, "model_bg", None) is not None and isinstance(
            hparams.model_bg, str):
        hparams.model_bg = yaml.safe_load(hparams.model_bg)
    return hparams


def get_nerf_dataset_args(hparams):
    """opts_nerf.py:294-308 adapter: repackage classic-NeRF loader args."""
    args = argparse.Namespace()
    args.dataset_type = hparams.dataset_type
    args.datadir = hparams.dataset_path
    args.factor = hparams.llff_factor
    args.spherify = hparams.spheric_poses
    args.llffhold = hparams.llffhold
    args.no_ndc = hparams.dataset_type != "llff" or hparams.no_ndc
    args.half_res = False
    args.testskip = hparams.testskip
    args.white_bkgd = hparams.white_bkgd
    args.scale_factor = hparams.scale_factor
    args.bungee_ray_nearfar = hparams.bungee_ray_nearfar
    args.shape = getattr(hparams, "shape", "cube")
    return args
