"""The port's classic-NeRF runner (``Runner.train_nerf``, ``eval_nerf``,
the ``train_nerf_moe`` / ``eval_nerf_moe`` entry points) vs the JAX
package's, on the CPU, on a synthetic Bungee scene (17 PNGs of 48x36,
scale factor 3: 15 train images of 16x12, images 0 and 16 held out) at the
tiny Bungee config: the mip renderer and no-drop MoE dispatch.

Training: both runners start from one JAX step-0 checkpoint and take 3
steps of 960 rays (one epoch), perturb 0 (the two packages draw from
different generators), a checkpoint at step 2 and at the end. No token
ties: the step-1 gradients agree within 8.6e-6 of each leaf's largest
entry (float32 sums in another order). Every parameter of step 2 agrees
within 1e-5 of its leaf's largest entry. Step 3's parameters are held to
1e-4: Adam divides each element's first moment by the root of its second,
so an element whose gradients nearly cancel across steps turns those
float32 differences into a larger share of its update (measured: the xyz
stem's kernel 3.0e-5 and the zero-initialised gate-input LayerNorm bias
4.5e-5 of their leaves at step 3; every other leaf within 1e-5). Adam's
moments are held to 1e-4 * max(1, the largest entry), the rule of
tests/test_torch_train_runner.py. The JAX runner resumed from the PORT's
step-2 checkpoint reaches the port's step 3 within 1e-5 (measured 1.3e-6):
the checkpoint crosses both ways.
Eval: the test split's metrics agree (PSNR 1e-4 dB, SSIM 1e-5, LPIPS 1e-4
relative), with the same files and metric keys.
"""
import copy
import json

import jax
import numpy as np
import pytest
import torch

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import runner as jrunner
from switch_nerf_tpu import train_nerf_moe as jtrain
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import _msgpack
from switch_nerf_torch import eval_nerf_moe as teval
from switch_nerf_torch import train_nerf_moe as ttrain
from tests.torch_port_helpers import (jax_train_state, make_bungee_scene,
                                      tiny_bungee_hparams)
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401

N_IMAGES = 17


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_bungee_scene(tmp_path_factory.mktemp("bungee"))


@pytest.fixture(scope="module")
def jax_checkpoint(scene, tmp_path_factory):
    h = tiny_bungee_hparams(scene, "unused")
    state = jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, N_IMAGES), None)
    root = tmp_path_factory.mktemp("ckpt0")
    jckpt.save_checkpoint(root, state)
    return root / "0"


def train_hparams(scene, exp, ckpt):
    h = tiny_bungee_hparams(scene, exp)
    h.perturb = 0.0
    h.batch_size = 960              # 2,880 train rays: 3 steps an epoch
    h.num_epochs = 1
    h.ckpt_interval = 2
    h.i_print = 1
    h.ckpt_path = str(ckpt)
    return h


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree.float() if torch.is_tensor(tree)
                                 else tree)


def read_step(models, step):
    d = models / str(step)
    tree = dict(flat(_msgpack.unpackb((d / "state.msgpack").read_bytes())))
    return tree, json.loads((d / "extra.json").read_text())


def assert_states_close(got, want, param_tol):
    """Every leaf but the JAX PRNG key (the port carries it as loaded):
    counters equal, parameters within param_tol of the leaf's largest
    entry, Adam's moments within 1e-4 * max(1, the largest entry) (module
    docstring)."""
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
            assert err <= param_tol * scale, (path, err, scale)
        else:
            assert err <= 1e-4 * max(1.0, scale), (path, err, scale)


@pytest.fixture(scope="module")
def jax_run(scene, jax_checkpoint, tmp_path_factory):
    exp = tmp_path_factory.mktemp("jax_train")
    jtrain.main(train_hparams(scene, exp, jax_checkpoint))
    return exp / "0" / "models"


def test_train_nerf_matches_jax(scene, jax_checkpoint, jax_run, tmp_path):
    state = ttrain.main(train_hparams(scene, tmp_path / "t", jax_checkpoint),
                        device="cpu")
    assert state.step == 3
    tmodels = tmp_path / "t" / "0" / "models"
    assert sorted(p.name for p in tmodels.iterdir()) == \
        sorted(p.name for p in jax_run.iterdir()) == ["2", "3"]
    for step in (2, 3):
        got, gextra = read_step(tmodels, step)
        want, wextra = read_step(jax_run, step)
        assert_states_close(got, want, 1e-5 if step == 2 else 1e-4)
        for key in ("iteration", "host_iteration", "dataset_state",
                    "dataset_index"):
            assert gextra[key] == wextra[key], key
    assert gextra["host_iteration"] == 3
    log = (tmp_path / "t" / "0" / "log.txt").read_text()
    assert "iter 3/3 " in log and "coarse_loss=" in log

    # the port's step-2 checkpoint into the JAX runner: its step 3 is the
    # port's
    h = train_hparams(scene, tmp_path / "j", tmodels / "2")
    jtrain.main(h)
    got, _ = read_step(tmp_path / "j" / "0" / "models", 3)
    want, _ = read_step(tmodels, 3)
    assert_states_close(got, want, 1e-5)


def files(exp):
    return sorted(str(p.relative_to(exp)) for p in exp.rglob("*")
                  if p.is_file() and p.relative_to(exp).parts[0] != "tb")


def keys(path):
    return [line.split(":")[0] for line in path.read_text().splitlines()]


def test_eval_nerf_matches_jax(scene, jax_checkpoint, tmp_path):
    h = tiny_bungee_hparams(scene, tmp_path / "j")
    h.ckpt_path = str(jax_checkpoint)
    jmeans = jrunner.Runner(h).eval_nerf()   # JAX's eval_nerf_moe.main
    ht = copy.copy(h)
    ht.exp_name = str(tmp_path / "t")
    tmeans = teval.main(ht, device="cpu")
    assert list(tmeans) == list(jmeans)
    for k, v in jmeans.items():
        if k in ("time", "memory"):
            continue
        tol = {"psnr": 1e-4, "ssim": 1e-5}.get(k, 1e-4 * abs(v))
        assert abs(tmeans[k] - v) <= tol, (k, tmeans[k], v)
    texp, jexp = tmp_path / "t" / "0", tmp_path / "j" / "0"
    assert files(texp) == files(jexp)
    for name in ("metrics_0.txt", "metrics_16.txt", "metrics.txt"):
        assert keys(texp / "test_images_0" / name) == \
            keys(jexp / "test_images_0" / name)
    assert (texp / "test_images_0" / "metrics.txt").read_text().startswith(
        "step 0 test\n")
