"""Move parameters between the JAX package's tree and the port's modules.

The tree is ``params["nerf"]`` or ``params["bg_nerf"]`` as
``switch_nerf_tpu.trainer.create_train_state`` builds it, given as nested
dicts of numpy arrays. The port names its submodules as the flax modules
are named, so a flax path maps to a torch parameter name leaf by leaf:

    <mods>/kernel [in, out]      -> <mods>.weight [out, in] (transposed)
    <mods>/bias                  -> <mods>.bias
    <mods>/scale (LayerNorm)     -> <mods>.weight
    <mods>/embedding             -> <mods>.weight
    <mods>/experts/w{i}, b{i}    -> <mods>.experts.w{i}, b{i} (same layout)

Every leaf must find its parameter and every parameter its leaf; anything
left over or missing raises. ``export_jax_params`` maps the other way, port
modules -> the nested dict of numpy arrays, so a trained port model can be
compared leaf by leaf with the JAX package's tree. (``scripts/
convert_torch_ckpt.py`` maps the reference's torch layout to JAX.)
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from switch_nerf_torch.models.common import Embedding, LayerNorm, TorchLinear

__all__ = ["load_jax_params", "load_jax_state", "export_jax_params",
           "export_jax_state"]


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def _torch_name(path: tuple):
    """(torch parameter name, whether the array is transposed)."""
    *mods, leaf = path
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), True
    if leaf in ("scale", "embedding"):
        return ".".join(mods + ["weight"]), False
    return ".".join(path), False


def load_jax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy every leaf of a flax parameter tree into `module`, in place."""
    params = dict(module.named_parameters())
    unused = set(params)
    for path, arr in _flatten(tree).items():
        name, transpose = _torch_name(path)
        if name not in params:
            raise KeyError(f"flax leaf {'/'.join(path)} has no port "
                           f"parameter {name!r}")
        if transpose:
            arr = arr.T
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != port "
                             f"{name} {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
        unused.discard(name)
    if unused:
        raise KeyError(f"port parameters with no flax leaf: {sorted(unused)}")


def load_jax_state(model: nn.Module, bg_model: Optional[nn.Module],
                   params: Mapping) -> None:
    """Load {"nerf": ..., "bg_nerf": ...} into the fg (and bg) model."""
    load_jax_params(model, params["nerf"])
    if bg_model is not None:
        load_jax_params(bg_model, params["bg_nerf"])
    elif "bg_nerf" in params:
        raise KeyError("params hold bg_nerf but no background model was given")


# the flax leaf name of each port parameter, by owning module type
_LEAVES = {TorchLinear: {"weight": "kernel", "bias": "bias"},
           LayerNorm: {"weight": "scale", "bias": "bias"},
           Embedding: {"weight": "embedding"}}


def export_jax_params(module: nn.Module) -> Dict:
    """The module's parameters as a flax-layout nested dict of fp32 numpy
    arrays (Linear weights transposed back to [in, out]). Every parameter
    lands in the tree; one whose module type has no known flax layout
    raises."""
    tree: Dict = {}
    for mod_name, mod in module.named_modules():
        leaves = _LEAVES.get(type(mod))
        for pname, p in mod.named_parameters(recurse=False):
            if leaves is not None:
                if pname not in leaves:
                    raise KeyError(f"{mod_name}.{pname}: no flax leaf for "
                                   f"{type(mod).__name__}.{pname}")
                leaf = leaves[pname]
            elif any(isinstance(mod, t) for t in _LEAVES):
                raise KeyError(f"{mod_name}: subclass {type(mod).__name__} "
                               "has no known flax layout")
            else:
                leaf = pname                # ExpertMLP w{i} / b{i}
            arr = p.detach().float().cpu().numpy()
            if leaf == "kernel":
                arr = arr.T
            node = tree
            for part in mod_name.split(".") if mod_name else ():
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(arr)
    return tree


def export_jax_state(model: nn.Module, bg_model: Optional[nn.Module]) -> Dict:
    """{"nerf": ..., "bg_nerf": ...} as the JAX package's train state holds
    them (bg only with a background model)."""
    tree = {"nerf": export_jax_params(model)}
    if bg_model is not None:
        tree["bg_nerf"] = export_jax_params(bg_model)
    return tree
