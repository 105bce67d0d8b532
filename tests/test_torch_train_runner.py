"""The port's training runner (runner.Runner.train) vs the JAX package's, on
the CPU.

On the 24x16 synthetic scene of
tests/test_torch_runner.py, at the tiny Building config (fp32, padded
train dispatch, background NeRF), perturb 0 and sigma noise off (the two
packages draw from different generators), both runners start from one JAX
step-0 checkpoint and train 6 steps with --ckpt_interval 3, on the memory
and the filesystem dataset, the JAX package on its numpy ray path. The
saved states of steps 3 and 6 agree leaf by leaf within 1e-4 of each
leaf's largest entry (parameters and both Adam moments), and extra.json's
counters and dataset cursor are equal. The port resumes a JAX-written
mid-run checkpoint and feeds the batches the JAX run fed after it.
"""
import json

import jax
import numpy as np
import pytest
import torch

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import native
from switch_nerf_tpu import runner as jrunner
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import _msgpack
from switch_nerf_torch import runner as trunner
from switch_nerf_torch import train as ttrain
from switch_nerf_torch.models import moe as tmoe
from tests.torch_port_helpers import jax_train_state, make_mega_scene
from tests.torch_port_helpers import mega_train_hparams as train_hparams
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401

STEPS, CKPT = 6, 3


@pytest.fixture(scope="module")
def mega_dataset(tmp_path_factory):
    return make_mega_scene(tmp_path_factory.mktemp("mega"))


@pytest.fixture(scope="module")
def jax_checkpoint(mega_dataset, tmp_path_factory):
    """A JAX step-0 checkpoint of the scene's model (5 appearance rows)."""
    h = train_hparams(mega_dataset, "unused", "memory")
    state = jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, 5), jmu.get_bg_nerf(h, 5))
    root = tmp_path_factory.mktemp("ckpt0")
    jckpt.save_checkpoint(root, state)
    return root / "0"


def record_batches(monkeypatch, runner_cls):
    """Every numpy batch `runner_cls._put_batch` is given, in order."""
    seen = []
    real = runner_cls._put_batch

    def put(self, batch, *a, **k):
        seen.append({key: np.array(v, np.float32) for key, v in batch.items()})
        return real(self, batch, *a, **k)
    monkeypatch.setattr(runner_cls, "_put_batch", put)
    return seen


@pytest.fixture(scope="module", params=["memory", "filesystem"])
def jax_train(request, mega_dataset, jax_checkpoint, tmp_path_factory):
    """The JAX Runner's 6 steps from the step-0 checkpoint: (dataset type,
    its models dir, the batches it fed)."""
    tmp = tmp_path_factory.mktemp(f"jax_{request.param}")
    h = train_hparams(mega_dataset, tmp / "exp", request.param,
                      tmp / "chunks")
    h.ckpt_path = str(jax_checkpoint)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(native, "get_lib", lambda: None)
        batches = record_batches(mp, jrunner.Runner)
        runner = jrunner.Runner(h)
        runner.train()
    finally:
        mp.undo()
    return request.param, runner.model_path, batches


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


def assert_states_close(got, want, strict_params):
    """Every leaf but the JAX PRNG key, which the port carries as it was
    loaded (its own draws come from a torch generator): counts equal,
    floats within 1e-4 * max(1, the leaf's largest entry) (the tolerance
    of tests/test_torch_train.py), and with `strict_params` every
    parameter within 1e-4 of its leaf's largest entry. Returns the largest
    error relative to the leaf's largest entry of the parameters and of
    the optimizer's moments."""
    assert sorted(got) == sorted(want)
    worst = {"params": 0.0, "opt_state": 0.0}
    for path, b in want.items():
        a = got[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path == ("rng",):
            continue
        if path == ("step",) or b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=str(path))
            continue
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        assert err <= 1e-4 * max(1.0, scale), (path, err)
        if strict_params and path[0] == "params":
            assert err <= 1e-4 * scale, (path, err, scale)
        if scale > 0:
            worst[path[0]] = max(worst[path[0]], err / scale)
    return worst


def record_gate_margins(monkeypatch):
    """Per MoE call of the port, the smallest gap between a token's two
    best gate probabilities (a near tie routes by the last bit)."""
    margins = []
    real = tmoe.extract_critical

    def run(gates, *a, **k):
        top2 = torch.topk(gates.detach(), 2, dim=1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return real(gates, *a, **k)
    monkeypatch.setattr(tmoe, "extract_critical", run)
    return margins


def test_train_matches_jax(jax_train, mega_dataset, jax_checkpoint,
                           tmp_path, monkeypatch):
    dataset_type, jmodels, _ = jax_train
    h = train_hparams(mega_dataset, tmp_path / "exp", dataset_type,
                      tmp_path / "chunks")
    h.ckpt_path = str(jax_checkpoint)
    margins = record_gate_margins(monkeypatch)
    state = ttrain.main(h, device="cpu")
    assert state.step == STEPS
    per_step = np.asarray(margins).reshape(STEPS, -1).min(1)   # 2 calls
    print(f"{dataset_type}: smallest top-2 gate gap per step {per_step}")
    tmodels = tmp_path / "exp" / "0" / "models"
    assert sorted(p.name for p in tmodels.iterdir()) == ["3", "6"]
    for step in (CKPT, STEPS):
        (tt, te), (jt, je) = read_step(tmodels, step), read_step(jmodels,
                                                                 step)
        assert any(p[:2] == ("opt_state", "0") and v.any()
                   for p, v in jt.items() if "mu" in p)
        # the memory run's step 6 routes a token whose two best gates tie
        # to the last float32 bits: the packages' last-bit differences send
        # it to different experts, so that step's parameters agree only to
        # a few 1e-4 of their leaf's largest entry
        flip = (dataset_type, step) == ("memory", STEPS)
        if flip:
            assert per_step[-1] < 1e-6
        worst = assert_states_close(tt, jt, strict_params=not flip)
        print(f"{dataset_type} step {step}: parameters within "
              f"{worst['params']:.2e}, moments within "
              f"{worst['opt_state']:.2e} of their leaf's largest entry")
        for key in ("iteration", "host_iteration", "dataset_index",
                    "dataset_state"):
            assert te[key] == je[key], (step, key)
        assert te["param_fingerprint"] == je["param_fingerprint"]
        assert "torch_generator_state" in te
    _, extra = read_step(tmodels, CKPT)
    assert extra["host_iteration"] == CKPT
    assert (extra["dataset_state"] is None) == (dataset_type == "memory")
    log = (tmp_path / "exp" / "0" / "log.txt").read_text()
    assert "generator is reseeded with 42" in log
    assert "Total parameters number is" in log


def test_resume_from_jax_checkpoint(jax_train, mega_dataset, tmp_path,
                                    monkeypatch):
    """The port resumes the JAX run's step-3 checkpoint and feeds the
    batches the JAX run fed from step 4 on."""
    dataset_type, jmodels, jbatches = jax_train
    h = train_hparams(mega_dataset, tmp_path / "exp", dataset_type,
                      tmp_path / "chunks")
    h.ckpt_path = str(jmodels / str(CKPT))
    seen = record_batches(monkeypatch, trunner.Runner)
    assert trunner.Runner(h, device="cpu").train().step == STEPS
    assert len(seen) == STEPS - CKPT
    for got, want in zip(seen, jbatches[CKPT:]):
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose(got["rays"], want["rays"], rtol=1e-6,
                                   atol=1e-6)
        for k in ("rgbs", "image_indices"):
            np.testing.assert_array_equal(got[k], want[k])
