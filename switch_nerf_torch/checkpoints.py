"""Checkpoint save/restore in the JAX package's single-host format.

Port of ``switch_nerf_tpu/checkpoints.py``. One checkpoint is a step
directory:

    <dir>/<step>/state.msgpack     the train-state tree as flax serializes
                                   it (params + optax opt_state + step +
                                   JAX PRNG key; ``bridge.py`` maps it to
                                   the port's ``trainer.TrainState``)
    <dir>/<step>/extra.json        iteration, host_iteration, dataset_state,
                                   dataset_index, np/python random states,
                                   param_fingerprint (sha1 over param
                                   paths/shapes/dtypes), and the port's
                                   own torch_generator_state (base64 of
                                   the train state's device generator)

so a checkpoint the JAX package wrote loads into the port and one the port
wrote loads into ``switch_nerf_tpu.checkpoints.load_checkpoint``. A save
publishes atomically (written into ``.tmp_<step>``, then renamed, with
extra.json, the commit marker, written last) and ``keep`` prunes older
steps. The msgpack codec is the port's own (``_msgpack.py``).

The device generator's state has no slot in the JAX tree, so it rides in
extra.json, which the JAX loader reads key by key (a port checkpoint still
loads there): ``torch_generator_state`` is rank 0's, and
``torch_generator_states`` every rank's, by rank. A load that restores the
random states gives each rank its own, so a resumed port run draws the
same perturbation, sigma noise and fine samples on every rank; a rank with
none in the checkpoint (written by the JAX package, by fewer processes, or
on another device type) keeps its generator reseeded with its initial
seed, and says so in the log.

A data-parallel run holds the same parameters on every rank, so its
checkpoint is the single-host format above, which the JAX package writes
for one process driving all its chips: every rank calls ``save_checkpoint``
(it gathers the generator states), rank 0 writes and the others wait at a
barrier; every rank reads the same files. Under expert parallelism every
rank also takes part in gathering the experts and their moments
(``bridge``), so rank 0 writes the bytes a data-parallel run writes for
the same state, and a load keeps each rank's block: either run resumes
from the other's checkpoint.

The JAX package's multi-process runs write the sharded (orbax) format
instead: ``<step>/orbax`` beside extra.json. It loads through the same
path: ``orbax_read.read_tree`` gives the tree ``state.msgpack`` would
hold, read without orbax, tensorstore or zstandard. The port writes
msgpack only.
"""
from __future__ import annotations

import base64
import hashlib
import json
import pickle
import random
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from switch_nerf_torch import _msgpack, bridge, orbax_read
from switch_nerf_torch.parallel import experts, host
from switch_nerf_torch.utils.logger import main_log

GENERATOR_KEY = "torch_generator_state"
GENERATOR_STATES_KEY = "torch_generator_states"


def _sorted_leaves(tree: Mapping, prefix=()):
    """(path, leaf) in the order jax.tree_util flattens a dict tree (keys
    sorted at every level)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _sorted_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _param_fingerprint(params: Mapping) -> str:
    """sha1 over every param leaf's (path, shape, dtype) of a flax-layout
    params tree of numpy arrays, byte for byte the JAX package's
    fingerprint: the path as ``jax.tree_util.keystr`` prints it
    (``['nerf']['layer_0']['kernel']``), then ``str(shape)`` and the dtype
    name."""
    h = hashlib.sha1()
    for path, leaf in _sorted_leaves(params):
        h.update("".join(f"[{k!r}]" for k in path).encode())
        h.update(str(tuple(np.shape(leaf))).encode())
        h.update(str(np.asarray(leaf).dtype).encode())
    return h.hexdigest()


def _state_fingerprint(state) -> str:
    return _param_fingerprint(bridge.jax_state_shapes(state.model,
                                                      state.bg_model))



def _jax_rng(state) -> np.ndarray:
    """The key to write: the one loaded, else jax.random.PRNGKey(seed)'s
    layout [0, seed] for the state's generator seed."""
    if state.rng is not None:
        return state.rng
    return np.array([0, state.generator.initial_seed() & 0xFFFFFFFF],
                    np.uint32)


def save_checkpoint(ckpt_dir, state, dataset_state: Optional[str] = None,
                    dataset_index: int = -1, keep: int = 0,
                    host_iteration: Optional[int] = None) -> Path:
    """Write a checkpoint of the port's ``TrainState`` at ``state.step``.
    Returns the step directory.

    host_iteration is the runner's batch counter (every consumed batch,
    skipped non-finite ones included); it defaults to state.step. In a
    process group every rank calls it: rank 0 writes, the others wait.
    """
    step = int(state.step)
    path = Path(ckpt_dir) / str(step)
    generators = host.all_gather_object(base64.b64encode(
        state.generator.get_state().numpy().tobytes()).decode())
    # expert parallel: every rank takes part in gathering the experts
    tree = (bridge.export_jax_train_state(state, _jax_rng(state))
            if experts.mesh_of(state.parameters()) is not None else None)
    if not host.is_main():
        host.barrier("checkpoint saved")
        return path
    extra = {
        "iteration": step,
        "host_iteration": (int(host_iteration) if host_iteration is not None
                           else step),
        "dataset_state": dataset_state,
        "dataset_index": dataset_index,
        "param_fingerprint": _state_fingerprint(state),
        "np_random_state": base64.b64encode(
            pickle.dumps(np.random.get_state())).decode(),
        "python_random_state": base64.b64encode(
            pickle.dumps(random.getstate())).decode(),
        GENERATOR_KEY: generators[0],
        GENERATOR_STATES_KEY: generators,
    }

    # atomic publish: write into a temp dir, rename into place; a crash
    # mid-save never leaves a half checkpoint that looks committed
    tmp = Path(ckpt_dir) / f".tmp_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    if tree is None:
        tree = bridge.export_jax_train_state(state, _jax_rng(state))
    (tmp / "state.msgpack").write_bytes(_msgpack.packb(tree))
    (tmp / "extra.json").write_text(json.dumps(extra))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)

    if keep > 0:
        # never prune the step just written; keep the (keep-1) highest
        # other steps
        others = sorted((int(p.name) for p in Path(ckpt_dir).iterdir()
                         if p.name.isdigit() and int(p.name) != step),
                        reverse=True)
        for old in others[keep - 1:]:
            shutil.rmtree(Path(ckpt_dir) / str(old), ignore_errors=True)
    host.barrier("checkpoint saved")
    return path


def latest_checkpoint(ckpt_dir) -> Optional[Path]:
    """Newest committed step dir: extra.json is written last, so a dir
    without it is a partial save and is skipped."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted((int(p.name) for p in ckpt_dir.iterdir()
                    if p.name.isdigit() and (p / "extra.json").exists()))
    return ckpt_dir / str(steps[-1]) if steps else None


def load_checkpoint(path, state, restore_rng_states: bool = True
                    ) -> Tuple[Any, Dict]:
    """Restore the port's ``TrainState`` in place from `path` (a step dir
    or a checkpoint root, whose newest committed step is taken).

    Returns (state, extra dict). With restore_rng_states, numpy's and
    Python's global random states and the state's generator (this rank's)
    are restored too.
    """
    path = Path(path)
    if (path / "state.msgpack").exists() or (path / "orbax").exists():
        step_dir = path
    else:
        step_dir = latest_checkpoint(path)
        if step_dir is None:
            raise FileNotFoundError(f"no checkpoint under {path}")

    extra_path = step_dir / "extra.json"
    if extra_path.exists():
        want = json.loads(extra_path.read_text()).get("param_fingerprint")
        have = _state_fingerprint(state)
        if want is not None and want != have:
            raise ValueError(
                f"checkpoint {step_dir} was saved with a different model "
                "architecture (param path/shape/dtype fingerprint "
                f"mismatch: ckpt {want[:12]}… vs template {have[:12]}…); "
                "check the model graph / width / expert-count hparams")

    if (step_dir / "orbax").exists():
        tree = orbax_read.read_tree(step_dir / "orbax")
    else:
        tree = _msgpack.unpackb((step_dir / "state.msgpack").read_bytes())
    bridge.load_jax_train_state(tree, state)

    extra = json.loads(extra_path.read_text())
    if restore_rng_states:
        if extra.get("np_random_state"):
            np.random.set_state(pickle.loads(
                base64.b64decode(extra["np_random_state"])))
        if extra.get("python_random_state"):
            random.setstate(pickle.loads(
                base64.b64decode(extra["python_random_state"])))
        states = extra.get(GENERATOR_STATES_KEY) or [
            extra.get(GENERATOR_KEY)]
        r = host.rank()
        _restore_generator(state.generator,
                           states[r] if r < len(states) else None, step_dir)
    return state, extra


def _restore_generator(generator: torch.Generator, encoded: Optional[str],
                       step_dir: Path) -> None:
    """Set the generator to a saved state; reseed it with its initial seed
    when there is none for this generator's type (the state of a CUDA
    generator does not fit a CPU one)."""
    raw = (np.frombuffer(base64.b64decode(encoded), np.uint8)
           if encoded else None)
    if raw is not None and raw.size == generator.get_state().numel():
        generator.set_state(torch.from_numpy(raw.copy()))
        return
    seed = generator.initial_seed()
    generator.manual_seed(seed)
    main_log(f"{step_dir}: no {generator.device.type} generator state in the "
             f"checkpoint; the generator is reseeded with {seed}")
