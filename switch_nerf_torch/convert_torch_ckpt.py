"""Convert a reference (MiZhenxing/Switch-NeRF, PyTorch) checkpoint into a
checkpoint of the port, with no JAX step.

    python -m switch_nerf_torch.convert_torch_ckpt <eval flags for the scene> \
        --torch_ckpt=<reference .pt> --out_ckpt=<output dir>

then serve it with ``--ckpt_path=<output dir>/<iteration>``. The port's
counterpart of ``scripts/convert_torch_ckpt.py``: the same name map (the
training-format ``expertmlp`` expert stacks the reference saves, the DDP
``module.`` prefix stripped, the dense background NeRF), mapped straight
onto the port's modules. The port keeps ``nn.Linear``'s [out, in] layout,
so no weight is transposed. The checkpoint is the single-host format
(``checkpoints.py``) at the ``.pt``'s ``iteration``, with fresh Adam
moments, as the script writes it. A parameter the ``.pt`` lacks keeps its
initial value, with a warning; a ``.pt`` entry the model has no parameter
for is dropped, as the script drops it.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from switch_nerf_torch.config import get_opts
from switch_nerf_torch.utils.crash import cli_entry

__all__ = ["convert_nerf_moe_state_dict", "convert_dense_nerf_state_dict",
           "load_converted", "main"]


def map_mlp(sd: Mapping, torch_prefix: str, out: Dict, port_prefix: str
            ) -> int:
    """An ``Mlp``'s fcs.i / norms.i -> fc{i} / norm{i}; returns the count."""
    i = 0
    while f"{torch_prefix}.fcs.{i}.weight" in sd:
        for leaf in ("weight", "bias"):
            out[f"{port_prefix}.fc{i}.{leaf}"] = \
                sd[f"{torch_prefix}.fcs.{i}.{leaf}"]
            norm = f"{torch_prefix}.norms.{i}.{leaf}"
            if norm in sd:
                out[f"{port_prefix}.norm{i}.{leaf}"] = sd[norm]
        i += 1
    return i


def _stack_leaf(key: str, parts, n: int, kind_at: int, what: str) -> tuple:
    """(tag, 'w' or 'b', j) of an expert stack's weights.j / bias.j key;
    any other layout raises."""
    if (len(parts) != n or parts[kind_at] not in ("weights", "bias")
            or not parts[kind_at + 1].isdigit()):
        raise ValueError(what.format(key=key))
    return (parts[1], "w" if parts[kind_at] == "weights" else "b",
            parts[kind_at + 1])


def convert_nerf_moe_state_dict(sd: Mapping) -> Dict[str, np.ndarray]:
    """Reference NeRFMoE state dict -> {port parameter name: array}.

    Name map (reference nerf_moe.py / tutel_moe_layer_nobatch.py):
      embedding_a.weight               -> embedding_a.weight
      affine.weight/bias               -> affine.weight/bias
      layers.<tag>.fcs.i.{weight,bias} -> layer_<tag>.fc{i}.{weight,bias}
      layers.<tag>.norms.i.*           -> layer_<tag>.norm{i}.*
      layers.<tag>.weight/bias (LN)    -> layer_<tag>.weight/bias
      layers.<t>.gates.0.wg.weight     -> layer_<t>.wg.weight
      layers.<t>.experts.0.weights.j   -> layer_<t>.experts.w{j} [E, in, out]
      layers.<t>.experts.0.bias.j      -> layer_<t>.experts.b{j}
      layers.<t>.residual_expert.*.j   -> layer_<t>.residual_expert.{w,b}{j}
      layers.<t>.coefficient.*         -> layer_<t>.coefficient.*
    """
    out: Dict[str, np.ndarray] = {}
    done = set()
    for key in list(sd):
        if key in done:
            continue
        parts = key.split(".")
        if key in ("embedding_a.weight", "affine.weight", "affine.bias"):
            out[key] = sd[key]
        elif ".residual_expert." in key:
            # DeepSpeed-style residual MoE: a 1-expert ExpertMLP stack; the
            # reference's seqexperts / ffn residual layouts fail loudly
            tag, name, j = _stack_leaf(
                key, parts, 5, 3,
                "unsupported residual_expert checkpoint layout at {key!r}: "
                "only the 'expertmlp' residual "
                "(residual_expert.weights.<j>/bias.<j>) converts")
            out[f"layer_{tag}.residual_expert.{name}{j}"] = sd[key]
        elif ".coefficient." in key:
            out[f"layer_{parts[1]}.coefficient.{parts[-1]}"] = sd[key]
        elif ".fcs." in key and key.startswith("layers."):
            tag = parts[1]
            map_mlp(sd, f"layers.{tag}", out, f"layer_{tag}")
            done.update(k for k in sd if k.startswith(
                (f"layers.{tag}.fcs.", f"layers.{tag}.norms.")))
        elif ".gates." in key and key.endswith("wg.weight"):
            out[f"layer_{parts[1]}.wg.weight"] = sd[key]
        elif ".experts." in key:
            tag, name, j = _stack_leaf(
                key, parts, 6, 4,
                "unsupported expert checkpoint layout at {key!r}: only the "
                "training-format 'expertmlp' stacks "
                "(experts.0.weights.<j>/bias.<j>) convert — migrate "
                "seqexperts/ffn checkpoints to expertmlp first")
            out[f"layer_{tag}.experts.{name}{j}"] = sd[key]
        elif (key.startswith("layers.") and len(parts) == 3
              and parts[2] in ("weight", "bias")):
            # bare LayerNorm tags (gate_input_norm)
            out[f"layer_{parts[1]}.{parts[2]}"] = sd[key]
    return out


def convert_dense_nerf_state_dict(sd: Mapping) -> Dict[str, np.ndarray]:
    """Reference dense NeRF (switch_nerf/models/nerf.py) -> port names:
    xyz_encodings.{i}.0.* (Sequential(Linear, ReLU)) -> xyz_encoding_{i}.*,
    dir_a_encoding.0.* -> dir_a_encoding.*; xyz_encoding_final, sigma,
    rgb, affine and embedding_a keep their names."""
    out: Dict[str, np.ndarray] = {}
    for key, v in sd.items():
        name = key.replace("dir_a_encoding.0.", "dir_a_encoding.")
        if name.startswith("xyz_encodings."):
            parts = name.split(".")          # xyz_encodings i 0 weight
            name = f"xyz_encoding_{parts[1]}.{parts[-1]}"
        out[name] = v
    return out


def _strip_module(sd: Mapping) -> Dict:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def load_converted(module: nn.Module, converted: Mapping[str, np.ndarray],
                   label: str) -> list:
    """Copy the converted arrays into `module`'s parameters of the same
    name, checking shapes; returns the names the conversion lacks (kept
    initialised, with the script's warning)."""
    missing = []
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name not in converted:
                missing.append(name)
                continue
            arr = np.asarray(converted[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{label}:{name} shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr.astype(np.float32)))
    if missing:
        print(f"WARNING: {label}: {len(missing)} params not found in the "
              f"torch checkpoint (kept initialised): {missing[:10]}")
    return missing


def _to_np(sd: Mapping) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().float().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}


def _parser():
    parser = get_opts()
    parser.add_argument("--torch_ckpt", type=str, required=True)
    parser.add_argument("--out_ckpt", type=str, required=True)
    return parser


@cli_entry(parser=_parser)
def main(hparams=None, device=None):
    """Convert ``--torch_ckpt`` into ``--out_ckpt``; returns the step
    directory written."""
    from switch_nerf_torch.checkpoints import save_checkpoint
    from switch_nerf_torch.runner import Runner
    from switch_nerf_torch.trainer import create_train_state

    ckpt = torch.load(hparams.torch_ckpt, map_location="cpu",
                      weights_only=False)
    iteration = int(ckpt.get("iteration", 0))
    runner = Runner(hparams, set_experiment_path=False, device=device)
    state = create_train_state(hparams, runner.nerf, runner.bg_nerf,
                               device=runner.device)

    sd = _strip_module(_to_np(ckpt["model_state_dict"]))
    load_converted(runner.nerf, convert_nerf_moe_state_dict(sd)
                   if hparams.use_moe else convert_dense_nerf_state_dict(sd),
                   "nerf")
    if runner.bg_nerf is not None and "bg_model_state_dict" in ckpt:
        bsd = _strip_module(_to_np(ckpt["bg_model_state_dict"]))
        load_converted(runner.bg_nerf, convert_nerf_moe_state_dict(bsd)
                       if hparams.bg_use_moe
                       else convert_dense_nerf_state_dict(bsd), "bg_nerf")
    state.step = iteration
    path = save_checkpoint(hparams.out_ckpt, state)
    print(f"wrote converted checkpoint to {path} (iteration {iteration})")
    return path


if __name__ == "__main__":
    main()
