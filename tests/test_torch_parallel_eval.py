"""Data-parallel serving of the port on the CPU: ``eval_image``, ``eval``
and ``eval_image_blocknerf`` in a real 2-process gloo group
(tests/torch_parallel_worker.py) against the port in one process and the
JAX package's single-process runner.

Image i belongs to rank i % 2, which renders it whole with the requests of
one process, so the 2-rank eval writes the one-process port's files with
the same pixels (the triptych JPEGs byte for byte) and the same records;
the means, gathered over the ranks, agree with the one-process port's to
1e-9 and with JAX's to PSNR 1e-4 dB, SSIM 1e-5 and LPIPS 1e-4 relative.
Scenes: the 24x16 Mega-NeRF scene with two val images at the tiny
Building config, and the Block-NeRF test scene (two masked val images) at
the tiny Mission-Bay-shaped config, each from a JAX step-0 checkpoint.
"""
import copy
import json

import jax
import pytest

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import runner as jrunner
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import eval as teval
from switch_nerf_torch import eval_image as teval_image
from switch_nerf_torch import eval_image_blocknerf as teval_block
from tests.torch_port_helpers import (Ranks, block_runner_hparams,
                                      jax_train_state, make_block_test_scene,
                                      mega_hparams, with_val_image)
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401

TOL = {"psnr": 1e-4, "psnr_mask": 1e-4, "ssim": 1e-5, "ssim_mask": 1e-5}


def close(got, want, rel=None):
    """Equal keys in order; values within TOL (LPIPS and the rest 1e-4
    relative), or all within `rel` relative; time and memory skipped."""
    assert list(got) == list(want)
    for k, v in want.items():
        if k.split("/")[-1] in ("time", "memory"):
            continue
        tol = (rel * max(abs(v), 1.0) if rel is not None
               else TOL.get(k.split("/")[-1], 1e-4 * abs(v)))
        assert abs(got[k] - v) <= tol, (k, got[k], v)


def lines(path):
    return {ln.split(": ")[0]: float(ln.split(": ")[1])
            for ln in path.read_text().splitlines()}


def files(base):
    return sorted(str(p.relative_to(base)) for p in base.rglob("*")
                  if p.is_file() and "tb" not in p.relative_to(base).parts)


@pytest.fixture(scope="module")
def mega(tmp_path_factory):
    scene = with_val_image(tmp_path_factory.mktemp("mega"))
    h = mega_hparams(scene, "unused")
    state = jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, 6), jmu.get_bg_nerf(h, 6))
    root = tmp_path_factory.mktemp("mega_ckpt")
    jckpt.save_checkpoint(root, state)
    return scene, root / "0"


@pytest.fixture(scope="module")
def block(tmp_path_factory):
    scene = make_block_test_scene(tmp_path_factory.mktemp("mission_bay"))
    h = block_runner_hparams(scene, "unused", "unused")
    ids = json.loads(scene["id_map"].read_text())
    rows = 1 + max(v if isinstance(v, int) else max(v.values())
                   for v in ids.values())
    state = jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, rows), None)
    root = tmp_path_factory.mktemp("mb_ckpt")
    jckpt.save_checkpoint(root, state)
    return scene, root / "0"


def mega_eval_hparams(mega, exp):
    scene, ckpt = mega
    h = mega_hparams(scene, exp)
    h.ckpt_path = str(ckpt)
    return h


def block_eval_hparams(block, exp):
    scene, ckpt = block
    return block_runner_hparams(scene, exp, "unused", ckpt_path=str(ckpt))


@pytest.fixture(scope="module")
def job(mega, block, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_eval")
    scenarios = [
        {"name": "eval_image", "kind": "eval", "entry": "eval_image",
         "h": mega_eval_hparams(mega, tmp / "eval_image")},
        {"name": "eval", "kind": "eval", "entry": "eval",
         "h": mega_eval_hparams(mega, tmp / "eval")},
        {"name": "blocknerf", "kind": "eval",
         "entry": "eval_image_blocknerf",
         "h": block_eval_hparams(block, tmp / "blocknerf")},
    ]
    return Ranks(tmp / "job.pkl", scenarios), tmp


def assert_same_files(two, one, *names):
    """The same file set; the named files byte for byte."""
    assert files(two) == files(one)
    for name in names:
        assert (two / name).read_bytes() == (one / name).read_bytes(), name


def test_eval_image_two_ranks(job, mega, tmp_path):
    ranks, dp = job
    jmeans = jrunner.Runner(mega_eval_hparams(mega, tmp_path / "j")) \
        .eval_image()
    tmeans = teval_image.main(mega_eval_hparams(mega, tmp_path / "t"),
                              device="cpu")
    outs = ranks.get("eval_image")
    assert outs[0]["means"] == outs[1]["means"]
    close(outs[0]["means"], tmeans, rel=1e-9)
    close(outs[0]["means"], jmeans)
    two, one, jax_ = dp / "eval_image" / "0", tmp_path / "t" / "0", \
        tmp_path / "j" / "0"
    assert_same_files(two, one, "val_images/0.jpg", "val_images/1.jpg",
                      "images/0_pred.jpg", "images/1_depth.jpg")
    assert files(two) == files(jax_)
    for i in (0, 1):
        rec = f"images/metrics_{i}.txt"
        close(lines(two / rec), lines(one / rec), rel=1e-9)
        close(lines(two / rec), lines(jax_ / rec))
    close(lines(two / "metrics.txt"), lines(one / "metrics.txt"), rel=1e-9)
    close(lines(two / "metrics.txt"), lines(jax_ / "metrics.txt"))
    log = (two / "log.txt").read_text()
    assert "val image 0:" in log and "val image 1:" in log


def test_eval_two_ranks(job, mega, tmp_path):
    """The validation protocol (eval.py): every val image's metrics
    gathered, the means under val/ keys."""
    ranks, dp = job
    tmeans = teval.main(mega_eval_hparams(mega, tmp_path / "t"),
                        device="cpu")
    outs = ranks.get("eval")
    assert outs[0]["means"] == outs[1]["means"]
    close(outs[0]["means"], tmeans, rel=1e-9)
    two, one = dp / "eval" / "0", tmp_path / "t" / "0"
    assert files(two) == files(one)
    close(lines(two / "metrics.txt"), lines(one / "metrics.txt"), rel=1e-9)


def test_eval_image_blocknerf_two_ranks(job, block, tmp_path):
    pytest.importorskip("tensorflow")
    ranks, dp = job
    jmeans = jrunner.Runner(block_eval_hparams(block, tmp_path / "j")) \
        .eval_image_blocknerf()
    tmeans = teval_block.main(block_eval_hparams(block, tmp_path / "t"),
                              device="cpu")
    outs = ranks.get("blocknerf")
    assert outs[0]["means"] == outs[1]["means"]
    close(outs[0]["means"], tmeans, rel=1e-9)
    close(outs[0]["means"], jmeans)
    two, one, jax_ = dp / "blocknerf", tmp_path / "t", tmp_path / "j"
    hashes = sorted(p.stem for p in (one / "val_images").glob("*.jpg"))
    assert len(hashes) == 2
    assert_same_files(two, one, *(f"val_images/{k}.jpg" for k in hashes))
    assert files(two) == files(jax_)
    for k in hashes:
        rec = f"val_metrics/metrics-{k}.json"
        got = json.loads((two / rec).read_text())
        close(got, json.loads((one / rec).read_text()), rel=1e-9)
        close(got, json.loads((jax_ / rec).read_text()))
    summary = "0/metrics.txt"
    close(lines(two / summary), lines(one / summary), rel=1e-9)
    close(lines(two / summary), lines(jax_ / summary))
    # a one-process rerun in the 2-rank eval's directory skips every image
    # done and sums every record on disk
    again = copy.copy(block_eval_hparams(block, dp / "blocknerf"))
    assert teval_block.main(again, device="cpu") == {}
    close(lines(dp / "blocknerf" / "1" / "metrics.txt"), lines(two / summary),
          rel=1e-9)
