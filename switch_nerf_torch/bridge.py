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

``load_jax_train_state`` / ``export_jax_train_state`` carry the whole
train-state tree (step, params, optax's Adam and schedule state, optax
MultiSteps' window, the PRNG key) to and from the port's
``trainer.TrainState``; ``checkpoints.py`` reads and writes it.

Under expert parallelism a rank's ExpertMLP parameters are its block of
experts (``models/experts.localize`` tags them with the mesh). The tree
stays the whole one: a load keeps the rank's block of each expert leaf
(``local_tree`` does the same to a tree of numpy arrays), an export
gathers the blocks from the expert group (a collective: every rank
exports, in the same order), and ``whole_tree`` joins the ranks' local
trees. An expert leaf is one under ``experts`` with the experts as its
leading dimension, as JAX's ``parallel/mesh.py:expert_leaf_spec`` says.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from switch_nerf_torch.models.common import Embedding, LayerNorm, TorchLinear
from switch_nerf_torch.parallel.experts import gather_whole

__all__ = ["load_jax_params", "load_jax_state", "export_jax_params",
           "export_jax_state", "jax_state_shapes", "load_jax_train_state",
           "export_jax_train_state", "local_tree", "whole_tree"]


def _host(val) -> np.ndarray:
    """A leaf as numpy (a bfloat16 tensor, which numpy lacks, as fp32)."""
    if isinstance(val, torch.Tensor):
        return val.detach().float().cpu().numpy()
    return np.asarray(val)


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = _host(val)
    return flat


def _torch_name(path: tuple):
    """(torch parameter name, whether the array is transposed)."""
    *mods, leaf = path
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), True
    if leaf in ("scale", "embedding"):
        return ".".join(mods + ["weight"]), False
    return ".".join(path), False


def _local(arr: np.ndarray, p) -> np.ndarray:
    """The block of a whole expert leaf that parameter `p` holds (an
    expert-parallel parameter), else `arr`."""
    mesh = getattr(p, "expert_mesh", None)
    if mesh is None:
        return arr
    lo, hi = mesh.block(arr.shape[0])
    return arr[lo:hi]


def _whole(t: torch.Tensor, p) -> torch.Tensor:
    """The whole of a tensor shaped like parameter `p`: gathered from the
    expert group for an expert-parallel parameter."""
    mesh = getattr(p, "expert_mesh", None)
    return t if mesh is None else gather_whole([t], mesh)[0]


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
        arr = _local(arr, p)
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


def _flax_leaves(module: nn.Module) -> List[Tuple[tuple, nn.Parameter]]:
    """(flax path, parameter) for every parameter of `module`, in
    ``module.parameters()`` order. A parameter whose module type has no
    known flax layout raises."""
    out = []
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
            mods = tuple(mod_name.split(".")) if mod_name else ()
            out.append((mods + (leaf,), p))
    return out


def _to_flax(t: torch.Tensor, path: tuple, p=None) -> np.ndarray:
    """A tensor shaped like the parameter `p` at `path`, in flax layout
    (whole: gathered when `p` is expert-parallel)."""
    if p is not None:
        t = _whole(t.detach(), p)
    arr = t.detach().float().cpu().numpy()
    return np.ascontiguousarray(arr.T if path[-1] == "kernel" else arr)


def _from_flax(arr, path: tuple, like: torch.Tensor) -> torch.Tensor:
    """A flax-layout array as a tensor shaped, typed and placed like the
    parameter `like` at `path` (its block, when expert-parallel)."""
    arr = np.asarray(arr)
    if path[-1] == "kernel":
        arr = arr.T
    arr = _local(arr, like)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != port "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=like.device, dtype=like.dtype)


def _nest(pairs) -> Dict:
    """{path: leaf} pairs as a nested dict."""
    tree: Dict = {}
    for path, leaf in pairs:
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def export_jax_params(module: nn.Module) -> Dict:
    """The module's parameters as a flax-layout nested dict of fp32 numpy
    arrays (Linear weights transposed back to [in, out])."""
    return _nest((path, _to_flax(p, path, p))
                 for path, p in _flax_leaves(module))


def export_jax_state(model: nn.Module, bg_model: Optional[nn.Module]) -> Dict:
    """{"nerf": ..., "bg_nerf": ...} as the JAX package's train state holds
    them (bg only with a background model)."""
    tree = {"nerf": export_jax_params(model)}
    if bg_model is not None:
        tree["bg_nerf"] = export_jax_params(bg_model)
    return tree


def _whole_shape(p, path: tuple) -> tuple:
    shape = tuple(p.shape)
    mesh = getattr(p, "expert_mesh", None)
    if mesh is not None:
        shape = (shape[0] * mesh.expert,) + shape[1:]
    return shape[::-1] if path[-1] == "kernel" else shape


def jax_state_shapes(model: nn.Module, bg_model: Optional[nn.Module]
                     ) -> Dict:
    """``export_jax_state``'s tree with every leaf a read-only fp32 array
    of zeros of the leaf's whole shape, without a collective (the
    checkpoints' architecture fingerprint)."""
    tree = {}
    for key, mod in (("nerf", model), ("bg_nerf", bg_model)):
        if mod is not None:
            tree[key] = _nest(
                (path, np.broadcast_to(np.float32(0), _whole_shape(p, path)))
                for path, p in _flax_leaves(mod))
    return tree


def _is_expert_leaf(path: tuple, arr, num_experts: int) -> bool:
    return ("experts" in path[:-1] and np.ndim(arr) >= 1
            and np.shape(arr)[0] == num_experts)


def _map_expert_leaves(tree, fn, num_experts: int, path=()):
    if isinstance(tree, Mapping):
        return {k: _map_expert_leaves(v, fn, num_experts, path + (str(k),))
                for k, v in tree.items()}
    return fn(tree) if _is_expert_leaf(path, tree, num_experts) else tree


def local_tree(tree: Mapping, index: int, size: int, num_experts: int
               ) -> Dict:
    """A train-state (or parameter) tree with every expert leaf (its
    moments and accumulated gradients too) cut to the block of experts
    that member `index` of an expert axis of `size` holds."""
    local = num_experts // size
    return _map_expert_leaves(
        tree, lambda a: a[index * local:(index + 1) * local], num_experts)


def whole_tree(trees: List[Mapping], num_experts: int) -> Dict:
    """The members' local trees (by expert index) joined into the whole
    one: expert leaves concatenated along the experts, the rest taken
    from member 0."""
    local = num_experts // len(trees)

    def join(path, nodes):
        if isinstance(nodes[0], Mapping):
            return {k: join(path + (str(k),), [n[k] for n in nodes])
                    for k in nodes[0]}
        if _is_expert_leaf(path, nodes[0], local):
            return (torch.cat(list(nodes)) if torch.is_tensor(nodes[0])
                    else np.concatenate(nodes))
        return nodes[0]
    return join((), list(trees))


# ------------------------------------------------------------ train state --

def _state_leaves(train_state) -> List[Tuple[tuple, nn.Parameter]]:
    """(flax path from the params root, parameter) in the order of
    ``train_state.parameters()``."""
    leaves = [(("nerf",) + path, p)
              for path, p in _flax_leaves(train_state.model)]
    if train_state.bg_model is not None:
        leaves += [(("bg_nerf",) + path, p)
                   for path, p in _flax_leaves(train_state.bg_model)]
    return leaves


def _sorted_tree(tree):
    """Dict keys sorted at every level, as flax writes a dict's state
    (a namedtuple's, such as optax's states, keeps its field order)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def _sorted_nest(pairs) -> Dict:
    return _sorted_tree(_nest(pairs))


def _i32(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


def export_jax_train_state(train_state, rng) -> Dict:
    """The port's ``trainer.TrainState`` as the JAX package's train-state
    tree ``{"opt_state", "params", "rng", "step"}`` with numpy leaves, in
    the key order ``flax.serialization.to_state_dict`` gives the state of
    ``switch_nerf_tpu.trainer.create_train_state`` (so its msgpack bytes
    are flax's).

    opt_state is optax.adam's ``{"0": {count, mu, nu}, "1": {count}}``
    (``"1": {}`` without the learning-rate schedule), from
    ``torch.optim.Adam``'s step/exp_avg/exp_avg_sq (zeros for a parameter
    Adam has not stepped) and ``opt_step``; with ``acc_grads`` it is
    optax.MultiSteps' ``{mini_step, gradient_step, inner_opt_state,
    acc_grads, skip_state}``.

    rng: the JAX PRNG key to write (uint32[2]). The port draws from a
    torch generator, whose state has no JAX counterpart, so the key is
    carried opaquely: the caller passes the key it loaded, or
    ``[0, seed]``, the layout of ``jax.random.PRNGKey(seed)``.
    """
    ts = train_state
    leaves = _state_leaves(ts)
    states = [ts.optimizer.state.get(p, {}) for _, p in leaves]
    counts = {int(st["step"]) for st in states if "step" in st}
    if len(counts) > 1:
        raise ValueError(f"Adam's parameters disagree on the step: {counts}")
    adam = {"count": _i32(counts.pop() if counts else 0)}
    for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        adam[key] = _sorted_nest(
            (path, _to_flax(st[moment], path, p) if moment in st
             else np.zeros(_whole_shape(p, path), np.float32))
            for (path, p), st in zip(leaves, states))
    inner = {"0": adam,
             "1": {"count": _i32(ts.opt_step)} if ts.scheduled_lr else {}}
    if ts.acc_grads is not None:
        opt_state = {
            "mini_step": _i32(ts.mini_step),
            "gradient_step": _i32(ts.opt_step),
            "inner_opt_state": inner,
            "acc_grads": _sorted_nest((path, _to_flax(g, path, p))
                                      for (path, p), g
                                      in zip(leaves, ts.acc_grads)),
            "skip_state": {}}
    else:
        opt_state = inner
    params = _sorted_tree(export_jax_state(ts.model, ts.bg_model))
    return {"opt_state": opt_state, "params": params,
            "rng": np.asarray(rng, np.uint32).reshape(2),
            "step": _i32(ts.step)}


def load_jax_train_state(state_tree: Mapping, train_state) -> None:
    """Load the JAX package's train-state tree (as ``export_jax_train_state``
    describes it; e.g. a decoded ``state.msgpack``) into the port's
    ``trainer.TrainState``, in place: parameters, step, Adam's moments and
    count, the schedule count (``opt_step``) and, with accumulation, the
    MultiSteps window (``mini_step``, ``acc_grads``). The JAX PRNG key is
    kept as it came in ``train_state.rng``. The tree's optimizer layout
    must match the state's (accumulation and schedule on or off), and
    every leaf must find its parameter, or this raises."""
    ts = train_state
    opt = state_tree["opt_state"]
    multi = "inner_opt_state" in opt
    if multi != (ts.acc_grads is not None):
        raise ValueError(
            "checkpoint optimizer layout does not match the train state: "
            f"gradient accumulation {'on' if multi else 'off'} in the "
            f"checkpoint, {'on' if ts.acc_grads is not None else 'off'} in "
            "the state (--accumulation_steps)")
    inner = opt["inner_opt_state"] if multi else opt
    adam, sched = inner["0"], inner["1"]
    if bool(sched) != ts.scheduled_lr:
        raise ValueError(
            "checkpoint optimizer layout does not match the train state: "
            "the learning-rate schedule is "
            f"{'on' if sched else 'off'} in the checkpoint "
            "(--no_optimizer_schedulers)")
    leaves = _state_leaves(ts)
    trees = {"mu": _flatten(adam["mu"]), "nu": _flatten(adam["nu"])}
    if multi:
        trees["acc_grads"] = _flatten(opt["acc_grads"])
    want = {path for path, _ in leaves}
    for name, flat in trees.items():
        if set(flat) != want:
            raise KeyError(f"opt_state {name}: leaves "
                           f"{sorted(set(flat) ^ want)[:4]} do not match "
                           "the parameters")

    load_jax_state(ts.model, ts.bg_model, state_tree["params"])
    count = int(adam["count"])
    for path, p in leaves:
        ts.optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": _from_flax(trees["mu"][path], path, p),
            "exp_avg_sq": _from_flax(trees["nu"][path], path, p)}
    ts.step = int(state_tree["step"])
    ts.rng = np.array(state_tree["rng"], np.uint32)
    if multi:
        ts.opt_step = int(opt["gradient_step"])
        ts.mini_step = int(opt["mini_step"])
        ts.acc_grads = [_from_flax(trees["acc_grads"][path], path, p)
                        for path, p in leaves]
    else:
        ts.opt_step = int(sched["count"]) if sched else count
