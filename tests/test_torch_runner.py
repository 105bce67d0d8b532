"""The port's eval runner (runner.py, eval_image.py, eval.py) vs the JAX
package's Runner, on the CPU, end to end on a synthetic Mega-NeRF scene.

One JAX checkpoint of the tiny Building config (MoE with --moe_test_batch,
background NeRF on) is evaluated by the JAX Runner and by the port's
eval_image CLI with device="cpu". Tolerances: the rendered results (every
key, rgb_fine included) to 1e-4, relative where large (the eval step's);
per-image and mean metrics psnr to 1e-4 dB, ssim to 1e-5, LPIPS to 1e-4
relative. The experiment directories hold the same files (TensorBoard
events aside: the port writes them through torch.utils.tensorboard where
the JAX package needs TensorFlow), with the same metrics keys in the same
order.
"""
import copy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import runner as jrunner
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import eval as teval
from switch_nerf_torch import eval_image as teval_image
from switch_nerf_torch import runner as trunner
from switch_nerf_torch.datasets import ray_utils as tray
from switch_nerf_tpu.datasets import ray_utils as jray
from tests.torch_port_helpers import (block_runner_hparams, jax_train_state,
                                      make_block_test_scene, make_mega_scene)
from tests.torch_port_helpers import mega_hparams as hparams
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401


@pytest.fixture(scope="module")
def mega_dataset(tmp_path_factory):
    return make_mega_scene(tmp_path_factory.mktemp("mega"))


@pytest.fixture(scope="module")
def checkpoint(mega_dataset, tmp_path_factory):
    """A JAX checkpoint of the scene's model (5 appearance rows)."""
    h = hparams(mega_dataset, "unused")
    state = jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, 5), jmu.get_bg_nerf(h, 5))
    root = tmp_path_factory.mktemp("ckpt")
    jckpt.save_checkpoint(root, state)
    return root


def capture_renders(monkeypatch, runner_cls):
    """Record every render_image result of `runner_cls`."""
    seen = []
    real = runner_cls.render_image

    def render_image(self, metadata, render_chunks):
        res = real(self, metadata, render_chunks)
        seen.append(res)
        return res
    monkeypatch.setattr(runner_cls, "render_image", render_image)
    return seen


def files(exp: Path):
    return sorted(str(p.relative_to(exp)) for p in exp.rglob("*")
                  if p.is_file() and p.relative_to(exp).parts[0] != "tb")


def keys(path: Path):
    return [line.split(":")[0] for line in path.read_text().splitlines()]


def assert_metrics_close(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if k in ("time", "memory"):
            continue
        if k == "psnr":
            tol = 1e-4
        elif k == "ssim":
            tol = 1e-5
        else:
            tol = 1e-4 * abs(v)
        assert abs(got[k] - v) <= tol, (k, got[k], v)


@pytest.fixture(scope="module")
def jax_eval(mega_dataset, checkpoint, tmp_path_factory):
    exp = tmp_path_factory.mktemp("jax_exp")
    h = hparams(mega_dataset, exp)
    h.ckpt_path = str(checkpoint)
    mp = pytest.MonkeyPatch()
    try:
        renders = capture_renders(mp, jrunner.Runner)
        means = jrunner.Runner(h).eval_image()
    finally:
        mp.undo()
    return means, renders, exp / "0"


def test_eval_image_matches_jax(mega_dataset, checkpoint, jax_eval,
                                tmp_path, monkeypatch):
    jmeans, jrenders, jexp = jax_eval
    h = hparams(mega_dataset, tmp_path / "exp")
    h.ckpt_path = str(checkpoint)
    trenders = capture_renders(monkeypatch, trunner.Runner)
    tmeans = teval_image.main(h, device="cpu")
    texp = tmp_path / "exp" / "0"

    assert len(trenders) == len(jrenders) == 1
    (tres,), (jres,) = trenders, jrenders
    assert sorted(tres) == sorted(jres)
    assert tres["rgb_fine"].shape == (16, 24, 3)
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)

    assert_metrics_close(tmeans, jmeans)
    assert "lpips-vgg-substitute" in tmeans and tmeans["memory"] == 0.0
    assert files(texp) == files(jexp)
    assert "images/0_depth_fg.jpg" in files(texp)
    assert keys(texp / "metrics.txt") == keys(jexp / "metrics.txt")
    mt, mj = (keys(e / "images" / "metrics_0.txt") for e in (texp, jexp))
    assert mt == mj and mt[:2] == ["psnr", "ssim"]
    assert (texp / "image_indices.txt").read_text() == \
        (jexp / "image_indices.txt").read_text()


def test_eval_matches_jax(mega_dataset, checkpoint, tmp_path):
    """The validation-protocol CLI: val/ mean keys and values."""
    h = hparams(mega_dataset, tmp_path / "t")
    h.ckpt_path = str(checkpoint)
    tmeans = teval.main(h, device="cpu")
    hj = hparams(mega_dataset, tmp_path / "j")
    hj.ckpt_path = str(checkpoint)
    jmeans = jrunner.Runner(hj).eval()
    assert list(tmeans) == list(jmeans)
    assert "val/lpips/vgg-substitute" in tmeans
    for k, v in jmeans.items():
        assert abs(tmeans[k] - v) <= 1e-4 * max(1.0, abs(v)), k
    assert keys(tmp_path / "t" / "0" / "metrics.txt") == \
        keys(tmp_path / "j" / "0" / "metrics.txt")


def test_runner_refusals(mega_dataset, checkpoint, tmp_path):
    h = hparams(mega_dataset, tmp_path / "e")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trunner.Runner(h)
    # no --moe_test_batch (no-drop eval dispatch, the reference default):
    # eval and eval_image run and match the JAX Runner's in that mode
    # (metrics as test_eval_image_matches_jax holds them, the same keys)
    nodrop = copy.copy(h)
    nodrop.moe_test_batch = False
    nodrop.ckpt_path = str(checkpoint)
    for method in ("eval_image", "eval"):
        got, want = ({}, {})
        for side, runner_cls, kw in (("t", trunner.Runner, {"device": "cpu"}),
                                     ("j", jrunner.Runner, {})):
            hs = copy.copy(nodrop)
            hs.exp_name = str(tmp_path / f"{side}_{method}")
            (got if side == "t" else want).update(
                getattr(runner_cls(hs, **kw), method)())
        assert_metrics_close(
            {k.replace("val/", ""): v for k, v in got.items()},
            {k.replace("val/", ""): v for k, v in want.items()})
    # and in-train validation runs in that mode
    nodrop.ckpt_path = None
    nodrop.moe_train_batch = True
    nodrop.dataset_type = "memory"
    nodrop.batch_size = 64
    nodrop.train_iterations = 1
    nodrop.val_interval = 1
    assert trunner.Runner(nodrop, set_experiment_path=False,
                          device="cpu").train().step == 1
    nodrop.val_interval = 2
    assert trunner.Runner(nodrop, set_experiment_path=False,
                          device="cpu").train().step == 1
    # a Block-NeRF runner: mip rendering, no background model, one
    # appearance row per id of the hash -> id map; serving needs a
    # checkpoint
    scene = make_block_test_scene(tmp_path / "block")
    block = trunner.Runner(block_runner_hparams(scene, tmp_path / "be",
                                                tmp_path / "bc"),
                           set_experiment_path=False, device="cpu")
    assert block.mip and block.bg_nerf is None
    assert block.appearance_count == 4
    with pytest.raises(ValueError, match="--ckpt_path"):
        block.eval_image_blocknerf()

    runner = trunner.Runner(h, set_experiment_path=False, device="cpu")
    with pytest.raises(ValueError, match="--ckpt_path"):
        runner.eval_image()
    for method in ("eval_points", "eval_ckpt"):
        with pytest.raises(ValueError, match="--ckpt_path"):
            getattr(runner, method)()
    # a container path is served (container.py), and must exist
    h.container_path = str(tmp_path / "somewhere")
    for method in ("eval_image", "eval_points", "eval_ckpt"):
        with pytest.raises(FileNotFoundError, match="somewhere"):
            getattr(runner, method)()

    # the published Building training command (README's, without
    # --moe_test_batch) builds a runner at full width
    from switch_nerf_torch.config import get_opts, parse_args
    published = parse_args(get_opts(), [
        "--config_file=configs/switch_nerf/building.yaml", "--use_moe",
        f"--exp_name={tmp_path / 'b'}", f"--dataset_path={mega_dataset}",
        f"--chunk_paths={tmp_path / 'chunks'}", "--use_moe_external_gate",
        "--use_gate_input_norm", "--moe_expert_type=expertmlp",
        "--batch_prioritized_routing", "--moe_capacity_factor=1.0",
        "--batch_size=8192", "--moe_l_aux_wt=0.0005", "--moe_train_batch"])
    assert not published.moe_test_batch
    runner = trunner.Runner(published, device="cpu")
    assert tuple(runner.nerf.layer_0.experts.w0.shape) == (8, 256, 256)


@pytest.mark.parametrize("center_pixels", [True, False])
def test_rays_match_jax(center_pixels, monkeypatch):
    """The port's numpy rays vs the JAX package's numpy path to 1e-6, and
    vs its native C++ path to that path's own tolerance against numpy
    (rtol 1e-5, tests/test_native.py)."""
    from switch_nerf_tpu import native
    rng = np.random.default_rng(3)
    c2w = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                          rng.normal(0, 0.3, (3, 1))], 1).astype(np.float32)
    c2w[0, 3] = -0.6
    intr = np.array([30.0, 28.0, 16.5, 11.0], np.float32)
    for alt in (None, [-0.9, 0.4]):
        args = (c2w, 33, 21, intr, center_pixels, 0.05, 1e5, alt)
        got = tray.compute_image_rays(*args)
        if native.get_lib() is not None:
            np.testing.assert_allclose(got, jray.compute_image_rays(*args),
                                       rtol=1e-5, atol=1e-6)
        with monkeypatch.context() as m:
            m.setattr(native, "compute_rays_native", lambda *a: None)
            want = jray.compute_image_rays(*args)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        d = jray.get_ray_directions(33, 21, *intr, center_pixels)
        np.testing.assert_allclose(
            tray.get_rays(d, c2w, 0.05, 2.0, alt),
            jray.get_rays(d, c2w, 0.05, 2.0, alt), rtol=1e-6, atol=1e-6)
        batch = np.stack([c2w, c2w * 0.9])
        np.testing.assert_allclose(
            tray.get_rays_batch(d.reshape(1, -1, 3).repeat(2, 0), batch,
                                0.05, 2.0, alt),
            jray.get_rays_batch(d.reshape(1, -1, 3).repeat(2, 0), batch,
                                0.05, 2.0, alt), rtol=1e-6, atol=1e-6)
