"""The port's Block-NeRF (Mission Bay) runner (``Runner.train`` on the
chunked tfrecord scene, ``Runner.eval_image_blocknerf``, the ``train`` and
``eval_image_blocknerf`` entry points) vs the JAX package's, on the CPU, at
a tiny Mission-Bay-shaped config (mission_bay.yaml with the README's flags,
fp32, 4 experts x 3 layers of width 32, appearance_dim 48, 9 + 9 samples;
padded train dispatch, no-drop eval dispatch) on a synthetic scene of GZIP
tfrecords (tests/torch_port_helpers.make_block_test_scene). The JAX side
reads the records through TensorFlow (``pytest.importorskip``).

Training: both runners start from one JAX step-0 checkpoint and take 3
steps of 64 rays, perturb 0 (the packages draw from different generators),
a checkpoint at step 2 and the final. Every parameter within 1e-4 of its
leaf's largest entry at steps 2 and 3 (PR 7's step-3 rule: Adam divides
a tiny first-step gradient by its own magnitude plus eps, so float32
sum-order noise in it becomes a share of a whole update). Measured: one
element of layer 2's kernel (its input row of appearance dimension 33)
1.41e-5 of the leaf at steps 2 and 3, whose Adam moments agree to 1e-7
relative; the zero-initialised gate-input LayerNorm bias 7.7e-6; every
other leaf within 4.5e-7. Adam's moments within 1e-4 * max(1, the
largest entry); counters and cursors equal. Eval: two masked val images; PSNR (and masked PSNR) 1e-4 dB, SSIM
1e-5, LPIPS 1e-4 relative; the same files, metric keys and summary. A
resumed eval's summary sums every record on disk over the id map's
val_image_num, as the JAX package does with one process.
"""
import copy
import json

import jax
import numpy as np
import pytest
import torch

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import _msgpack
from switch_nerf_torch import eval_image_blocknerf as teval
from switch_nerf_torch import train as ttrain
from tests.torch_port_helpers import (block_runner_hparams, jax_train_state,
                                      make_block_test_scene)
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401


@pytest.fixture(autouse=True)
def _crash_reports_in_tmp(tmp_path, monkeypatch):
    """The entry points' crash reports go to the test's directory."""
    monkeypatch.setenv("SWITCH_NERF_ERROR_FILE", str(tmp_path / "err.json"))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_block_test_scene(tmp_path_factory.mktemp("mission_bay"))


@pytest.fixture(scope="module")
def jax_checkpoint(scene, tmp_path_factory):
    h = block_runner_hparams(scene, "unused", "unused")
    # the runners' appearance rows: the id map's largest value + 1 (its
    # val_image_num counts as one, as in the JAX package)
    ids = json.loads(scene["id_map"].read_text())
    rows = 1 + max(v if isinstance(v, int) else max(v.values())
                   for v in ids.values())
    state = jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, rows), None)
    root = tmp_path_factory.mktemp("mb_ckpt0")
    jckpt.save_checkpoint(root, state)
    return root / "0"


def _read_step(models, step):
    d = models / str(step)

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, prefix + (k,))
        else:
            yield prefix, np.asarray(tree.float() if torch.is_tensor(tree)
                                     else tree)
    tree = dict(flat(_msgpack.unpackb((d / "state.msgpack").read_bytes())))
    return tree, json.loads((d / "extra.json").read_text())


def test_runner_train_matches_jax(scene, jax_checkpoint, tmp_path):
    """Both runners from one JAX step-0 checkpoint, 3 steps of 64 rays on
    the chunked tfrecord scene (one checkpoint at step 2 and the final):
    counters, cursors and every leaf agree (module docstring)."""
    from switch_nerf_tpu import train as jtrain
    pytest.importorskip("tensorflow")
    hj = block_runner_hparams(scene, tmp_path / "j", tmp_path / "jchunks",
                         ckpt_path=str(jax_checkpoint))
    jtrain.main(hj)
    ht = block_runner_hparams(scene, tmp_path / "t", tmp_path / "tchunks",
                         ckpt_path=str(jax_checkpoint))
    state = ttrain.main(ht, device="cpu")
    assert state.step == 3
    jmodels, tmodels = (tmp_path / k / "0" / "models" for k in "jt")
    assert sorted(p.name for p in tmodels.iterdir()) == \
        sorted(p.name for p in jmodels.iterdir()) == ["2", "3"]
    for step in (2, 3):
        got, gextra = _read_step(tmodels, step)
        want, wextra = _read_step(jmodels, step)
        assert sorted(got) == sorted(want)
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
                limit = 1e-4 * scale
            else:
                limit = 1e-4 * max(1.0, scale)
            assert err <= limit, (step, path, err, scale)
        for key in ("iteration", "host_iteration", "dataset_state",
                    "dataset_index"):
            assert gextra.get(key) == wextra.get(key), (step, key)
    log = (tmp_path / "t" / "0" / "log.txt").read_text()
    assert "iter 3 " in log and "coarse_loss=" in log


def _files(base):
    return sorted(str(p.relative_to(base)) for p in base.rglob("*")
                  if p.is_file() and "tb" not in p.relative_to(base).parts)


def _keys(path):
    return [ln.split(":")[0] for ln in path.read_text().splitlines()]


def _summary(path):
    return {ln.split(": ")[0]: float(ln.split(": ")[1])
            for ln in path.read_text().splitlines()}


def _check_means(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if k in ("time", "memory"):
            continue
        tol = {"psnr": 1e-4, "psnr_mask": 1e-4, "ssim": 1e-5,
               "ssim_mask": 1e-5}.get(k, 1e-4 * abs(v))
        assert abs(got[k] - v) <= tol, (k, got[k], v)


def test_eval_image_blocknerf_matches_jax(scene, jax_checkpoint, tmp_path):
    """Two masked val images served by both packages (no --moe_test_batch:
    no-drop dispatch): the same means, per-image records, metric keys and
    files, and the same 'Average val/...' summary."""
    from switch_nerf_tpu.runner import Runner as JRunner
    pytest.importorskip("tensorflow")
    hj = block_runner_hparams(scene, tmp_path / "j", "unused",
                         ckpt_path=str(jax_checkpoint))
    jmeans = JRunner(hj).eval_image_blocknerf()
    ht = block_runner_hparams(scene, tmp_path / "t", "unused",
                         ckpt_path=str(jax_checkpoint))
    tmeans = teval.main(ht, device="cpu")
    _check_means(tmeans, jmeans)
    assert {"psnr_mask", "ssim_mask"} <= set(tmeans)
    jbase, tbase = tmp_path / "j", tmp_path / "t"
    assert _files(tbase) == _files(jbase)
    hashes = sorted(p.stem[len("metrics-"):]
                    for p in (tbase / "val_metrics").glob("*.json"))
    assert len(hashes) == 2
    for k in hashes:
        assert _keys(tbase / "images" / f"metrics_{k}.txt") == \
            _keys(jbase / "images" / f"metrics_{k}.txt")
        _check_means(
            json.loads((tbase / "val_metrics" / f"metrics-{k}.json")
                       .read_text()),
            json.loads((jbase / "val_metrics" / f"metrics-{k}.json")
                       .read_text()))
    ts, js = (_summary(b / "0" / "metrics.txt") for b in (tbase, jbase))
    _check_means({k[len("Average "):].replace("val/", "", 1): v
                  for k, v in ts.items()},
                 {k[len("Average "):].replace("val/", "", 1): v
                  for k, v in js.items()})


def test_eval_image_blocknerf_resumes(scene, jax_checkpoint, tmp_path):
    """An image whose triptych exists is skipped; the summary of the rerun
    sums every record on disk over the id map's val_image_num, so it
    equals the first pass's (the JAX package's aggregate, one process)."""
    h = block_runner_hparams(scene, tmp_path / "t", "unused",
                        ckpt_path=str(jax_checkpoint))
    first = teval.main(copy.copy(h), device="cpu")
    base = tmp_path / "t"
    hashes = sorted(p.stem for p in (base / "val_images").glob("*.jpg"))
    (base / "val_images" / f"{hashes[0]}.jpg").unlink()
    again = teval.main(copy.copy(h), device="cpu")
    rec = json.loads((base / "val_metrics" / f"metrics-{hashes[0]}.json")
                     .read_text())
    assert again["psnr"] == pytest.approx(rec["psnr"])
    assert first["psnr"] != pytest.approx(again["psnr"])
    s0, s1 = (_summary(base / v / "metrics.txt") for v in ("0", "1"))
    assert list(s0) == list(s1)
    for k in s0:
        if not k.endswith(("time", "memory")):
            assert s1[k] == pytest.approx(s0[k], rel=1e-6), k
    assert s0["Average val/psnr"] == pytest.approx(first["psnr"], rel=1e-6)
