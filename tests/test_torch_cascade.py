"""The cascade (--use_cascade) in the port vs the JAX package, on the CPU.

A ``Cascade`` holds a coarse and a fine model of the same graph: the
coarse pass is composited into rgb_coarse, the fine pass runs on the fine
model at the sorted union of the coarse and fine depths and is
composited alone, fg and bg, and the loss averages the two levels' photo
losses. Weights are drawn by the JAX package and bridged.

  * the module: each level, and a direct query (eval_points, the
    octree's grid) gets the coarse level, as JAX's default use_coarse;
    no fine level with --fine_samples 0 (outputs 1e-5);
  * the eval render at the tiny Building config with the background
    NeRF, both levels, fg and bg (every result 1e-5);
  * ``Runner.train`` on the 24x16 Mega-NeRF scene and ``Runner.
    train_nerf`` on a 32x32 blender scene (the classic NeRFMoE, no
    background), each 3 steps from one JAX step-0 checkpoint against the
    JAX runner: every parameter within 2e-5 of its leaf's largest entry,
    Adam's moments within 1e-4 (tests/test_torch_train_runner.py's rule);
    the blender run's val image rendered from the trained checkpoint by
    each package's eval step: PSNR within 1e-4 dB;
  * the checkpoint: a JAX-written cascade state loads into the port and
    the port writes it back byte for byte; JAX restores the port's.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import make_blender_scene
from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import native
from switch_nerf_tpu import runner as jrunner
from switch_nerf_tpu import train_nerf_moe as jtrain
from switch_nerf_tpu import trainer as jtrainer
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import bridge
from switch_nerf_torch import runner as trunner
from switch_nerf_torch import train as ttrain
from switch_nerf_torch import train_nerf_moe as ttrain_nerf
from switch_nerf_torch import trainer as ttrainer
from switch_nerf_torch.models import model_utils as tmu
from switch_nerf_torch.models.cascade import Cascade
from tests.test_torch_classic_runner import classic_hparams
from tests.test_torch_train_runner import read_step
from tests.torch_port_helpers import (checkpoint_bytes_both_ways, jax_params,
                                      jax_template, jax_train_state,
                                      make_mega_scene, mega_train_hparams,
                                      ray_batch, tiny_building_hparams, to_jax)
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401

SCENE = (np.zeros(3, np.float32), np.ones(3, np.float32))
STEPS = 3


def cascade_hparams():
    h = tiny_building_hparams()
    h.use_cascade = True
    h.moe_train_batch = True
    h.perturb = 0.0
    h.use_sigma_noise = False
    return h


@pytest.fixture(scope="module")
def bridged():
    h = cascade_hparams()
    jm, jbg = jmu.get_nerf(h, 8), jmu.get_bg_nerf(h, 8)
    params, np_params = jax_params(h, jm, jbg)
    tm = tmu.get_nerf(h, 8, device="cpu")
    tbg = tmu.get_bg_nerf(h, 8, device="cpu")
    bridge.load_jax_state(tm, tbg, np_params)
    return h, jm, jbg, params, tm, tbg


def _points(n, xyz_dim, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([rng.uniform(-1, 1, (n, xyz_dim)), d,
                           rng.integers(0, 8, (n, 1))], -1).astype(np.float32)


def _out(o):
    return o["outputs"] if isinstance(o, dict) else o


def test_levels_match_jax(bridged):
    h, jm, jbg, params, tm, tbg = bridged
    assert isinstance(tm, Cascade) and isinstance(tbg, Cascade)
    for jmod, tmod, p, xyz_dim in ((jm, tm, params["nerf"], 3),
                                   (jbg, tbg, params["bg_nerf"], 4)):
        pts = _points(200, xyz_dim, seed=xyz_dim)
        outs = {}
        with torch.no_grad():
            for use_coarse in (True, False):
                want = np.asarray(_out(jmod.apply(
                    {"params": p}, jnp.asarray(pts), use_coarse=use_coarse)))
                got = _out(tmod(torch.from_numpy(pts),
                                use_coarse=use_coarse)).numpy()
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
                outs[use_coarse] = got
            # a direct query: the coarse level, as JAX's default
            direct = _out(tmod(torch.from_numpy(pts))).numpy()
        np.testing.assert_array_equal(direct, outs[True])
        np.testing.assert_allclose(direct, np.asarray(_out(jmod.apply(
            {"params": p}, jnp.asarray(pts)))), rtol=1e-5, atol=1e-5)
        assert not np.allclose(outs[True], outs[False])
    # no fine level without fine samples, in both packages
    h0 = copy.copy(h)
    h0.fine_samples = 0
    t0 = tmu.get_nerf(h0, 8, device="cpu")
    assert t0.fine is None
    np0 = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax_template(h0, jmu.get_nerf(h0, 8), None).params)
    assert sorted(np0["nerf"]) == ["coarse"]
    bridge.load_jax_params(t0, np0["nerf"])


def test_render_matches_jax(bridged):
    """The eval render (make_eval_step, both levels, fg and bg)."""
    h, jm, jbg, params, tm, tbg = bridged
    batch = ray_batch(150, seed=3)
    jstep = jax.jit(jtrainer.make_eval_step(
        jm, jbg, h, jtrainer.render_config_from_hparams(h),
        jtrainer.SceneInfo(*map(jnp.asarray, SCENE))))
    want = jstep(params, to_jax(batch))
    got = ttrainer.make_eval_step(
        tm, tbg, h, ttrainer.render_config_from_hparams(h),
        ttrainer.SceneInfo(*SCENE), device="cpu")(batch)
    assert sorted(got) == sorted(want)
    for key in ("rgb_coarse", "rgb_fine", "bg_lambda_coarse",
                "fg_rgb_coarse", "bg_rgb_coarse", "bg_gate_loss_fine"):
        assert key in got, key
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def assert_leaves_close(got, want, param_tol=2e-5, moment_tol=1e-4):
    assert sorted(got) == sorted(want)
    worst = 0.0
    for path, b in want.items():
        a = got[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path == ("rng",):
            continue
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=str(path))
            continue
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        if path[0] == "params":
            assert err <= param_tol * scale, (path, err, scale)
            worst = max(worst, err / scale if scale else 0.0)
        else:
            assert err <= moment_tol * max(1.0, scale), (path, err)
    return worst


def test_runner_train_matches_jax(tmp_path):
    scene = make_mega_scene(tmp_path / "scene")
    h = mega_train_hparams(scene, tmp_path / "j", "memory")
    h.use_cascade = True
    h.train_iterations = STEPS
    h.ckpt_interval = STEPS
    state = jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, 5), jmu.get_bg_nerf(h, 5))
    jckpt.save_checkpoint(tmp_path / "ckpt0", state)
    h.ckpt_path = str(tmp_path / "ckpt0" / "0")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(native, "get_lib", lambda: None)
        jrun = jrunner.Runner(h)
        jrun.train()
    finally:
        mp.undo()
    ht = copy.copy(h)
    ht.exp_name = str(tmp_path / "t")
    tstate = ttrain.main(ht, device="cpu")
    assert isinstance(tstate.model, Cascade) and tstate.step == STEPS
    got, gextra = read_step(tmp_path / "t" / "0" / "models", STEPS)
    want, wextra = read_step(jrun.model_path, STEPS)
    assert any(p[:2] == ("params", "nerf") and p[2] == "fine" for p in want)
    worst = assert_leaves_close(got, want)
    print(f"Runner.train cascade: parameters within {worst:.2e}")
    assert gextra["param_fingerprint"] == wextra["param_fingerprint"]
    log = (tmp_path / "t" / "0" / "log.txt").read_text()
    assert "coarse_loss=" in log


def test_runner_train_nerf_and_eval_match_jax(tmp_path):
    """The classic NeRFMoE (no background) as a cascade: train_nerf_moe 3
    steps, and the val image's PSNR from the result, against JAX's."""
    make_blender_scene(tmp_path / "blender", 0, side=32)
    h = classic_hparams("blender", tmp_path / "blender", tmp_path / "j")
    h.use_cascade = True
    state = jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, 5), None)
    jckpt.save_checkpoint(tmp_path / "ckpt0", state)
    h.ckpt_path = str(tmp_path / "ckpt0" / "0")
    jtrain.main(h)
    ht = copy.copy(h)
    ht.exp_name = str(tmp_path / "t")
    tstate = ttrain_nerf.main(ht, device="cpu")
    assert tstate.step == STEPS
    got, _ = read_step(tmp_path / "t" / "0" / "models", STEPS)
    want, _ = read_step(tmp_path / "j" / "0" / "models", STEPS)
    worst = assert_leaves_close(got, want)
    print(f"Runner.train_nerf cascade: parameters within {worst:.2e}")

    # the trained JAX checkpoint through each package's eval step (the
    # runner's eval loop adds LPIPS, whose compile this test skips): the
    # val image's PSNR
    he = copy.copy(h)
    he.ckpt_path = str(tmp_path / "j" / "0" / "models" / str(STEPS))
    runner = trunner.Runner(he, device="cpu")
    state = runner._load_eval_state()
    assert isinstance(state.model, Cascade)
    sample = runner.val_set[0]
    rays = np.asarray(sample["rays"], np.float32).reshape(-1, 8)
    gt = np.asarray(sample["rgbs"], np.float32).reshape(-1, 3)
    batch = {"rays": rays, "image_indices": np.full(
        len(rays), float(sample["img_i"]), np.float32)}
    got = ttrainer.make_eval_step(
        state.model, None, he, ttrainer.render_config_from_hparams(he),
        ttrainer.SceneInfo(None, None), device="cpu")(batch)["rgb_fine"]
    jm = jmu.get_nerf(he, 5)
    jstate, _ = jckpt.load_checkpoint(he.ckpt_path,
                                      jax_template(he, jm, None))
    want = jax.jit(jtrainer.make_eval_step(
        jm, None, he, jtrainer.render_config_from_hparams(he),
        jtrainer.SceneInfo(None, None)))(jstate.params,
                                         to_jax(batch))["rgb_fine"]

    def psnr(x):
        return -10.0 * np.log10(np.mean((np.clip(x, 0, 1) - gt) ** 2))
    p_t, p_j = psnr(got.numpy()), psnr(np.asarray(want))
    print(f"val PSNR port {p_t:.6f}, JAX {p_j:.6f}")
    assert abs(p_t - p_j) <= 1e-4


def test_checkpoint_bytes_both_ways(tmp_path):
    h = cascade_hparams()
    want, got, restored, jtree = checkpoint_bytes_both_ways(h, tmp_path)
    assert got == want
    assert sorted(restored["nerf"]) == ["coarse", "fine"]
    assert sorted(restored["bg_nerf"]) == ["coarse", "fine"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, restored, jtree)
