"""The port's octree extraction (``switch_nerf_torch/octree.py``,
``create_octree_moe.py``) vs the JAX package's (``switch_nerf_tpu/
octree.py``, ``scripts/create_octree_moe.py``), on the CPU.

The octree functions on seeded occupancies: the same child and data
arrays, queries, grid points, thresholds and grid weights; the npz files
byte-equal (the zip entries' timestamps pinned), and each package reads
the other's tree. The extraction scripts on one JAX checkpoint each, of the
dense SH model of tests/test_octree.py and of a small SH MoE (the tiny
Building graph with a 12-wide SH colour head, no-drop eval): the same
child array and data within 1e-5 (the model queries in fp32, summed in
another order).
"""
import json
import sys
import time

import jax
import numpy as np
import pytest

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import octree as jo
from switch_nerf_tpu.config import parse_args as jparse_args
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import octree as to
from switch_nerf_torch.config import parse_args
from switch_nerf_torch.create_octree_moe import get_extraction_opts, main
from tests.torch_port_helpers import (jax_train_state, make_mega_scene,
                                      tiny_building_hparams)


def _payload(cells):
    rng = np.random.default_rng(int(cells.sum()) % 1000)
    return np.concatenate([cells.astype(np.float32),
                           rng.normal(size=(len(cells), 2))], -1)


@pytest.mark.parametrize("reso,density", [(8, 0.1), (16, 0.02), (32, 0.5)])
def test_build_and_query_match_jax(reso, density, tmp_path, monkeypatch):
    occ = np.random.default_rng(reso).random((reso,) * 3) < density
    occ[0, 0, 0] = occ[-1, -1, -1] = True
    center, radius = [0.1, -0.2, 0.3], [1.0, 0.5, 2.0]
    t = to.build_octree(occ, _payload, center, radius, "SH4")
    j = jo.build_octree(occ, _payload, center, radius, "SH4")
    for name in ("child", "data", "center", "radius"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (t.depth, t.data_format) == (j.depth, j.data_format)

    pts = np.random.default_rng(1).uniform(-3, 3, (2000, 3)).astype(
        np.float32)
    pts = np.concatenate([pts, to.grid_points(center, radius, reso)])
    np.testing.assert_array_equal(t.query(pts), j.query(pts))

    # byte-equal files (the zip timestamps pinned), read across
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    t.save(tmp_path / "t.npz")
    j.save(tmp_path / "j.npz")
    assert (tmp_path / "t.npz").read_bytes() == \
        (tmp_path / "j.npz").read_bytes()
    for a, b in ((to.Octree.load(tmp_path / "j.npz"), j),
                 (jo.Octree.load(tmp_path / "t.npz"), t)):
        np.testing.assert_array_equal(a.child, b.child)
        np.testing.assert_array_equal(a.data, b.data)
        assert (a.depth, a.data_format) == (b.depth, b.data_format)


def test_grid_helpers_match_jax():
    for reso in (4, 16):
        np.testing.assert_array_equal(
            to.grid_points([0, 1, 2], [1, 2, 3], reso),
            jo.grid_points([0, 1, 2], [1, 2, 3], reso))
        assert to.sigma_threshold_from_alpha(0.01, reso) == \
            jo.sigma_threshold_from_alpha(0.01, reso)
    rng = np.random.default_rng(2)
    sigma = rng.exponential(3.0, (16, 16, 16)).astype(np.float32)
    poses = []
    for z in (2.0, 20.0):
        p = np.eye(3, 4, dtype=np.float32)
        p[:, 3] = [0.1, -0.2, z]
        poses.append(p)
    cam = (16, 12, 10.0, 10.0, 8.0, 6.0)
    a = to.grid_weights(sigma, np.stack(poses), [0, 0, 0], [1, 1, 1], cam,
                        ray_subsample=2)
    b = jo.grid_weights(sigma, np.stack(poses), [0, 0, 0], [1, 1, 1], cam,
                        ray_subsample=2)
    np.testing.assert_array_equal(a, b)
    assert a.max() > 0


COMMON = ["--no_bg_nerf", "--sh_deg", "1", "--pos_xyz_dim", "2", "--no_amp",
          "--init_grid_depth", "4", "--alpha_thresh", "0.0005",
          "--scale_alpha_thresh", "0.0005", "--samples_per_cell", "2",
          "--model_chunk_size", "2048"]
DENSE = ["--appearance_dim", "0", "--pos_dir_dim", "0", "--layers", "2",
         "--skip_layers", "1", "--layer_dim", "16"]


def moe_flags():
    h = tiny_building_hparams()
    graph = h.model
    graph["layers"]["color"]["out_ch"] = 12
    return ["--use_moe", "--model", json.dumps(graph), "--moe_expert_num",
            "4", "--use_moe_external_gate", "--use_gate_input_norm",
            "--pos_dir_dim", "1", "--appearance_dim", "8",
            "--embedding_index", "3"]


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_create_octree_matches_jax_script(kind, tmp_path):
    from scripts.create_octree_moe import get_extraction_opts as jopts
    from scripts.create_octree_moe import main as jmain
    scene = make_mega_scene(tmp_path / "scene")
    argv = COMMON + (DENSE if kind == "dense" else moe_flags()) + [
        "--dataset_path", str(scene), "--exp_name", str(tmp_path / "exp")]
    jh = jparse_args(jopts(), argv + ["--output", "unused"])
    state = jax_train_state(
        jax.random.PRNGKey(4), jh, jmu.get_nerf(jh, 5), None)
    jckpt.save_checkpoint(tmp_path / "ckpt", state)
    argv += ["--ckpt_path", str(tmp_path / "ckpt" / "0")]

    old = sys.argv
    sys.argv = ["create_octree_moe"] + argv + [
        "--output", str(tmp_path / "j.npz")]
    try:
        jmain()
    finally:
        sys.argv = old
    tree = main(parse_args(get_extraction_opts(), argv + [
        "--output", str(tmp_path / "t.npz")]), device="cpu")
    want = jo.Octree.load(tmp_path / "j.npz")
    got = to.Octree.load(tmp_path / "t.npz")
    np.testing.assert_array_equal(got.child, want.child)
    assert got.data.shape == want.data.shape == (got.data.shape[0], 13)
    assert got.data.shape[0] > 0 and got.data_format == "SH4"
    np.testing.assert_allclose(got.data, want.data, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.center, want.center, rtol=1e-6)
    np.testing.assert_allclose(got.radius, want.radius, rtol=1e-6)
    np.testing.assert_array_equal(tree.child, got.child)
