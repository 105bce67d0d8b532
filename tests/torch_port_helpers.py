"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX package
and the port as arrays; weights are drawn by the JAX package and loaded
into the port through ``switch_nerf_torch.bridge``.
"""
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from __graft_entry__ import _building_hparams

_WORKER = Path(__file__).parent / "torch_parallel_worker.py"
_ROOT = Path(__file__).parent.parent


def tiny_building_hparams(width=16):
    """The tiny Building config (_building_hparams(tiny=True)) with eval in
    padded dispatch, fp32 (--no_amp) and the background NeRF on. `width`
    resizes the trunk (16 in the graft entry; the card's kernels take
    64/128/256)."""
    h = _building_hparams(tiny=True)
    h.moe_test_batch = True
    h.amp = False
    h.bg_nerf = True
    layers = h.model["layers"]
    for tag in ("xyz", "0", "1", "moe_external_gate", "gate_input_norm"):
        for key in ("in_ch", "h_ch", "out_ch", "gate_dim"):
            if layers[tag].get(key) == 16:
                layers[tag][key] = width
    layers["xyz"]["in_ch"] = 3 + h.pos_xyz_dim * 3 * 2
    layers["2"]["in_ch"] = width + 3 + h.pos_dir_dim * 3 * 2 \
        + h.appearance_dim
    layers["sigma"]["in_ch"] = width
    return h


def jax_train_state(key, h, model, bg_model):
    """JAX's ``create_train_state`` as one jitted program, in about half
    the wall time of its op-by-op run, which compiles each initialiser's
    ops one by one. Both packages' tests load its values, whatever they
    are; at the tiny Building and Bungee configs they equal the op-by-op
    run's bit for bit."""
    from switch_nerf_tpu.trainer import create_train_state
    return jax.jit(lambda k: create_train_state(k, h, model, bg_model))(key)


def jax_params(h, model, bg_model, seed=0):
    state = jax_train_state(jax.random.PRNGKey(seed), h, model, bg_model)
    return state.params, jax.tree_util.tree_map(np.asarray, state.params)


def jax_template(h, model, bg_model, seed=1):
    """The JAX train state of h's models as shapes and dtypes only
    (``jax.eval_shape``: nothing is initialised or compiled), the template
    a JAX checkpoint restores into or whose tree a test reads."""
    from switch_nerf_tpu.trainer import create_train_state
    return jax.eval_shape(
        lambda key: create_train_state(key, h, model, bg_model),
        jax.random.PRNGKey(seed))


@pytest.fixture(scope="module", autouse=True)
def jax_runners_from_shapes():
    """Autouse in each test module that imports it: the JAX runners made
    there build their train state from shapes alone (``jax.eval_shape`` of
    ``create_train_state``). Every runner of those modules loads a
    checkpoint over that state, so its initial values are never read;
    initialising them op by op compiles each op again for every runner (a
    runner's mesh keeps them out of JAX's op cache), seconds a runner. A
    runner without --ckpt_path fails on the shapes."""
    from switch_nerf_tpu import runner as jrunner
    real = jrunner.create_train_state

    def shaped(rng, *args, **kwargs):
        return jax.eval_shape(lambda key: real(key, *args, **kwargs), rng)
    jrunner.create_train_state = shaped
    try:
        yield
    finally:
        jrunner.create_train_state = real


def ray_batch(n, seed=0, n_images=8):
    """Rays from inside the unit sphere (the graft entry's _make_batch
    recipe, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 0.1
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.5), np.full((n, 1), 2.5)],
                          -1).astype(np.float32)
    idx = rng.integers(0, n_images, n).astype(np.float32)
    return {"rays": rays, "image_indices": idx}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def make_mega_scene(root):
    """A synthetic Mega-NeRF dataset in `root` (tests/test_runner_e2e.py's):
    coordinates.pt, and 4 train + 1 val 24x16 images, each with
    metadata/<name>.pt and rgbs/<name>.jpg."""
    w, h = 24, 16
    rng = np.random.default_rng(0)
    for split, names in (("train", ["000", "001", "002", "003"]),
                         ("val", ["004"])):
        (root / split / "metadata").mkdir(parents=True)
        (root / split / "rgbs").mkdir(parents=True)
        for name in names:
            # camera above origin looking down (+x is down in drb)
            c2w = np.eye(3, 4, dtype=np.float32)
            c2w[:, 3] = rng.normal(0, 0.1, 3).astype(np.float32)
            c2w[0, 3] -= 0.5
            torch.save({"c2w": torch.tensor(c2w), "W": w, "H": h,
                        "intrinsics": torch.tensor([20.0, 20.0, w / 2,
                                                    h / 2])},
                       root / split / "metadata" / f"{name}.pt")
            img = (rng.uniform(0, 255, (h, w, 3))).astype(np.uint8)
            Image.fromarray(img).save(root / split / "rgbs" / f"{name}.jpg")
    torch.save({"origin_drb": torch.zeros(3),
                "pose_scale_factor": 10.0}, root / "coordinates.pt")
    return root


def mega_hparams(root, exp):
    """The tiny Building config on make_mega_scene's scene: 24x16 val image
    (scale 1), 160-ray requests (384 rays: two full requests and a padded
    one)."""
    h = tiny_building_hparams()
    h.exp_name = str(exp)
    h.dataset_path = str(root)
    h.ray_altitude_range = [-30.0, 5.0]
    h.near = 0.5
    h.val_scale_factor = 1
    h.image_pixel_batch_size = 160
    return h


def mega_train_hparams(root, exp, dataset_type, chunks=None):
    """mega_hparams for training: padded train dispatch, perturb 0 and no
    sigma noise, 64-ray batches, 6 steps with a checkpoint every 3, no
    validation; for the filesystem dataset 4 chunks of 6 batches."""
    h = mega_hparams(root, exp)
    h.moe_train_batch = True
    h.perturb = 0.0
    h.use_sigma_noise = False
    h.dataset_type = dataset_type
    h.chunk_paths = [str(chunks)] if chunks is not None else None
    h.num_chunks = 4
    h.disk_flush_size = 1000
    h.batch_size = 64
    h.train_iterations = 6
    h.ckpt_interval = 3
    h.i_print = 2
    h.val_interval = 10 ** 9
    return h


BUNGEE_FLAGS = ["--config_file", "configs/switch_nerf/bungee.yaml",
                "--moe_expert_num", "4", "--no_amp",
                "--use_moe_external_gate", "--use_gate_input_norm"]


def make_bungee_scene(root, n=17, w=48, h=36, seed=0):
    """A synthetic Bungee-NeRF scene in `root`: poses_enu.json (scene_scale
    1e-4, the earth's centre 6371011 m below the ENU origin) and n smooth
    random PNGs of w x h under images/. The cameras hover 600-800 m up and
    look straight down, so every ray meets the building and earth spheres."""
    import json
    from pathlib import Path
    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        c2w = np.eye(3, 4)
        c2w[:, 3] = [rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02),
                     rng.uniform(0.06, 0.08)]
        hwf = np.array([[h], [w], [1.2 * w]])
        poses.append(np.concatenate([c2w, hwf], 1).reshape(-1).tolist()
                     + [0.0, 1.0])
        small = rng.uniform(0, 255, (h // 4 + 1, w // 4 + 1, 3))
        Image.fromarray(small.astype(np.uint8)).resize(
            (w, h), Image.BICUBIC).save(root / "images" / f"{i:03d}.png")
    (root / "poses_enu.json").write_text(json.dumps({
        "poses": poses, "scene_scale": 1e-4,
        "scene_origin": [0.0, 0.0, -6371011.0], "scale_split": [n]}))
    return root


def tiny_bungee_hparams(root, exp, width=64):
    """configs/switch_nerf/bungee.yaml with the README's flags (4 experts,
    fp32, external gate, gate-input norm; no --moe_*_batch: no-drop
    dispatch), cut to a 3-layer MoE of `width` with skip [1], 9 + 9
    samples, 64-ray batches and requests, a 100-point model chunk."""
    from switch_nerf_tpu.config import get_opts_nerf, parse_args
    hp = parse_args(get_opts_nerf(), BUNGEE_FLAGS + [
        "--dataset_path", str(root), "--exp_name", str(exp)])
    shrink = {256: width, 128: width // 2}
    for layer in hp.model["layers"].values():
        for key in ("in_ch", "h_ch", "out_ch", "gate_dim"):
            if layer.get(key) in shrink:
                layer[key] = shrink[layer[key]]
    hp.model["layers"]["0"]["num"] = 3
    hp.model["layers"]["0"]["skips"] = [1]
    hp.coarse_samples = hp.fine_samples = 9
    hp.batch_size = 64
    hp.image_pixel_batch_size = 64
    hp.model_chunk_size = 100
    return hp


MISSION_BAY_FLAGS = ["--config_file", "configs/switch_nerf/mission_bay.yaml",
                     "--moe_train_batch", "--use_moe_external_gate",
                     "--use_gate_input_norm", "--batch_prioritized_routing",
                     "--moe_capacity_factor", "1.0", "--moe_l_aux_wt",
                     "0.0005"]
BLOCK_W, BLOCK_H = 16, 12     # the Block-NeRF test scene's images
BLOCK_RECORDS = (("train_0000.tfrecord", 2), ("validation_0000.tfrecord", 2))


def make_block_test_scene(root):
    """chip_smoke.make_block_scene at 16x12 (2 train + 2 masked validation
    images, seed 3), with val_image_num in the id map (it divides the eval
    summary's sums). Returns its paths and "root"."""
    import json
    from chip_smoke import make_block_scene
    paths = make_block_scene(root, seed=3, w=BLOCK_W, h=BLOCK_H,
                             records=BLOCK_RECORDS)
    id_map = json.loads(paths["id_map"].read_text())
    id_map["val_image_num"] = paths["val_images"]
    paths["id_map"].write_text(json.dumps(id_map))
    paths["root"] = root
    return paths


def mission_bay_hparams(width=None, experts=2, layers=3, skips=(1,),
                        extra=()):
    """mission_bay.yaml with the README's flags, fp32 (--no_amp), cut to a
    MoE of `experts` x `layers` (skips) at `width` (None: the published
    512)."""
    from switch_nerf_tpu.config import get_opts, parse_args
    h = parse_args(get_opts(), MISSION_BAY_FLAGS + [
        "--exp_name", "unused", "--dataset_path", "unused", "--no_amp",
        "--moe_expert_num", str(experts), *extra])
    if width is not None:
        shrink = {512: width, 587: width + 75, 128: max(width // 2, 8)}
        for layer in h.model["layers"].values():
            for key in ("in_ch", "h_ch", "out_ch", "gate_dim"):
                if layer.get(key) in shrink:
                    layer[key] = shrink[layer[key]]
    h.model["layers"]["0"]["num"] = layers
    h.model["layers"]["0"]["skips"] = list(skips)
    return h


def block_runner_hparams(scene, exp, chunks, **kw):
    """The tiny Mission-Bay-shaped runner config: mission_bay_hparams cut
    to 4 experts x 3 layers of width 32 (skip 1), 9 + 9 samples, 64-ray
    batches, a 300-point model chunk, perturb 0, 3 steps with a checkpoint
    at step 2, on `scene` (make_block_test_scene) in 2 chunks."""
    h = mission_bay_hparams(width=32, experts=4, extra=[
        "--exp_name", str(exp), "--dataset_path", str(scene["root"]),
        "--block_train_list_path", str(scene["train"]),
        "--block_val_list_path", str(scene["val"]),
        "--block_image_hash_id_map_path", str(scene["id_map"]),
        "--dataset_type", "filesystem", "--chunk_paths", str(chunks),
        "--num_chunks", "2", "--batch_size", "64", "--coarse_samples", "9",
        "--fine_samples", "9", "--model_chunk_size", "300",
        "--image_pixel_batch_size", str(BLOCK_W * BLOCK_H), "--perturb",
        "0", "--train_iterations", "3", "--ckpt_interval", "2",
        "--i_print", "1"])
    for k, v in kw.items():
        setattr(h, k, v)
    return h


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """A job of tests/torch_parallel_worker.py in `world` processes (a gloo
    group on the CPU), started at once; ``get`` waits for it."""

    def __init__(self, job_path: Path, scenarios, world: int = 2, **job):
        self.job_path = job_path
        job_path.write_bytes(pickle.dumps(
            {"port": free_port(), "scenarios": scenarios, **job}))
        env = dict(os.environ, OMP_NUM_THREADS="2")
        self.procs = [subprocess.Popen(
            [sys.executable, str(_WORKER), str(r), str(world), str(job_path)],
            cwd=str(_ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self._results = None

    def _wait(self):
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        results = []
        for r, p in enumerate(self.procs):
            f = self.job_path.with_suffix(f".rank{r}.pkl")
            res = pickle.loads(f.read_bytes()) if f.exists() else {}
            results.append((res, p.returncode, outs[r] if r < len(outs)
                            else ""))
        return results

    def get(self, name: str):
        """Every rank's result of scenario `name`."""
        if self._results is None:
            self._results = self._wait()
        got = []
        for r, (res, rc, out) in enumerate(self._results):
            if name not in res or "error" in res[name]:
                pytest.fail(f"rank {r} (rc {rc}) of scenario {name}:\n"
                            f"{res.get(name, {}).get('error', '')}\n"
                            f"{out[-4000:]}")
            got.append(res[name])
        return got


def with_val_image(root):
    """make_mega_scene plus a second val image, 005: 004 mirrored, from a
    camera moved 0.05 sideways, so each rank of a 2-rank eval owns one."""
    make_mega_scene(root)
    md = torch.load(root / "val" / "metadata" / "004.pt", weights_only=False)
    md["c2w"] = md["c2w"].clone()
    md["c2w"][1, 3] += 0.05
    torch.save(md, root / "val" / "metadata" / "005.pt")
    img = np.asarray(Image.open(root / "val" / "rgbs" / "004.jpg"))
    Image.fromarray(np.ascontiguousarray(img[:, ::-1])).save(
        root / "val" / "rgbs" / "005.jpg")
    return root


def _reference_names(tree, moe: bool, prefix=()):
    """(reference torch name, transposed?) for every leaf path of a flax
    params tree: the inverse of scripts/convert_torch_ckpt.py's maps."""
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            yield from _reference_names(v, moe, path)
            continue
        *mods, leaf = path
        if mods == ["embedding_a"]:
            yield path, "embedding_a.weight", False
        elif not moe:
            name = mods[0]
            if name.startswith("xyz_encoding_") and name[-1].isdigit():
                name = f"xyz_encodings.{name.rsplit('_', 1)[1]}.0"
            elif name == "dir_a_encoding":
                name = "dir_a_encoding.0"
            yield (path, f"{name}.{'weight' if leaf == 'kernel' else leaf}",
                   leaf == "kernel")
        else:
            tag = mods[0][len("layer_"):]
            if len(mods) == 1:                       # a LayerNorm tag
                yield (path, f"layers.{tag}."
                       f"{'weight' if leaf == 'scale' else 'bias'}", False)
            elif mods[1] == "wg":
                yield path, f"layers.{tag}.gates.0.wg.weight", True
            elif mods[1] == "experts":
                kind = "weights" if leaf[0] == "w" else "bias"
                yield (path, f"layers.{tag}.experts.0.{kind}.{leaf[1:]}",
                       False)
            else:
                kind, i = ("fcs", mods[1][2:]) if mods[1].startswith("fc") \
                    else ("norms", mods[1][4:])
                leaf_name = {"kernel": "weight", "scale": "weight"}.get(
                    leaf, leaf)
                yield (path, f"layers.{tag}.{kind}.{i}.{leaf_name}",
                       leaf == "kernel")


def write_reference_pt(h, appearance_count, path, seed=0, iteration=7):
    """A reference-layout (MiZhenxing/Switch-NeRF) checkpoint of the
    hparams' models with random weights drawn from `seed`: the DDP
    ``module.`` prefix on the foreground's names, the dense background
    NeRF as bg_model_state_dict. Returns the JAX params tree it holds."""
    from switch_nerf_tpu.models import model_utils as jmu
    bg = jmu.get_bg_nerf(h, appearance_count) if h.bg_nerf else None
    state = jax_train_state(jax.random.PRNGKey(0), h,
                            jmu.get_nerf(h, appearance_count), bg)
    rng = np.random.default_rng(seed)
    params, ckpt = {}, {"iteration": iteration}
    for part, key, prefix, moe in (
            ("nerf", "model_state_dict", "module.", h.use_moe),
            ("bg_nerf", "bg_model_state_dict", "", False)):
        if part not in state.params:
            continue
        tree = jax.tree_util.tree_map(np.asarray, state.params[part])
        sd, out = {}, {}
        for leaf_path, name, transpose in _reference_names(tree, moe):
            leaf = tree
            for p in leaf_path:
                leaf = leaf[p]
            val = (rng.uniform(-1.0, 1.0, leaf.shape)
                   / np.sqrt(leaf.shape[-2] if leaf.ndim > 1 else 4.0)
                   ).astype(np.float32)
            node = out
            for p in leaf_path[:-1]:
                node = node.setdefault(p, {})
            node[leaf_path[-1]] = val
            sd[prefix + name] = torch.from_numpy(
                np.ascontiguousarray(val.T if transpose else val))
        ckpt[key] = sd
        params[part] = out
    torch.save(ckpt, path)
    return params


def checkpoint_bytes_both_ways(h, root, appearance_count=8, bg=True):
    """A JAX step-0 train state of h's models, written by the JAX package,
    loaded into the port's models (every leaf must find its parameter) and
    written again by the port; then the port's checkpoint restored by the
    JAX package. Returns (JAX's state.msgpack bytes, the port's, the JAX
    tree the port's checkpoint restores to, the JAX state's tree)."""
    from flax import serialization

    from switch_nerf_tpu import checkpoints as jckpt
    from switch_nerf_tpu.models import model_utils as jmu
    from switch_nerf_torch import checkpoints as tckpt
    from switch_nerf_torch import trainer as ttrainer
    from switch_nerf_torch.models import model_utils as tmu

    jm = jmu.get_nerf(h, appearance_count)
    jbg = jmu.get_bg_nerf(h, appearance_count) if bg else None
    jstate = jax_train_state(jax.random.PRNGKey(0), h, jm, jbg)
    jckpt.save_checkpoint(root / "jax", jstate)
    tm = tmu.get_nerf(h, appearance_count, device="cpu", seed=5)
    tbg = (tmu.get_bg_nerf(h, appearance_count, device="cpu", seed=6)
           if bg else None)
    ts = ttrainer.create_train_state(h, tm, tbg, device="cpu")
    tckpt.load_checkpoint(root / "jax", ts, restore_rng_states=False)
    out = tckpt.save_checkpoint(root / "port", ts)
    restored, _ = jckpt.load_checkpoint(root / "port",
                                        jax_template(h, jm, jbg))
    want = (root / "jax" / "0" / "state.msgpack").read_bytes()
    got = (out / "state.msgpack").read_bytes()
    return (want, got,
            serialization.to_state_dict(jax.device_get(restored.params)),
            serialization.to_state_dict(jax.device_get(jstate.params)))
