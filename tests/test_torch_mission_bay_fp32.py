"""Mission Bay in fp32 (--no_amp) at its published width on the CPU: two
port train steps against JAX's ``make_train_step`` (mip rendering, the
512-wide MoE trunk cut to 2 experts x 3 layers, appearance_dim 48 over 5
ids, no background model), 64 rays of 8 + 8 samples, perturb 0 and no
sigma noise (the frameworks draw different noise). On the card the same
step runs K1 and K2 in fp32 at M = 512 (chip_smoke.py's Mission Bay
phase holds it against the CPU).

Tolerance: every metric within 1e-5 (relative, at least 1); every
parameter within 1e-4 of its leaf's largest entry (at least 1) after each
step, the repo's fp32 train-step hold (tests/test_torch_train.py). A
tighter 1e-5 does not hold for a reason that is no fault: in this case
one ReLU of expert 0's first layer sits at a tie (its output unit 173
takes gradients 100x further apart than the other 511 units' 4e-12), the
gradients there are ~1e-9, near Adam's eps, and Adam's g / (|g| + eps)
turns their few-percent difference into 1.14e-5 of a parameter.
"""
import jax
import numpy as np
import torch

from switch_nerf_tpu import trainer as jtrainer
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import bridge
from switch_nerf_torch import trainer as ttrainer
from switch_nerf_torch.models import model_utils as tmu
from tests.torch_port_helpers import (jax_train_state, mission_bay_hparams,
                                      to_jax)

IDS, RAYS = 5, 64


def _hparams():
    h = mission_bay_hparams(extra=["--coarse_samples", "8", "--fine_samples",
                                   "8", "--batch_size", str(RAYS)])
    h.perturb = 0.0
    h.use_sigma_noise = False
    h.train_iterations = 100
    return h


def _batch(seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(RAYS, 3)) * 0.1
    d = rng.normal(size=(RAYS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((RAYS, 1), 0.1),
                           np.full((RAYS, 1), 2.0)], -1).astype(np.float32)
    return {"rays": rays,
            "radii": rng.uniform(1e-4, 1e-3, (RAYS, 1)).astype(np.float32),
            "rgbs": rng.uniform(size=(RAYS, 3)).astype(np.float32),
            "image_indices": rng.integers(0, IDS, RAYS).astype(np.float32)}


def test_fp32_train_steps_at_width_512_match_jax():
    h = _hparams()
    assert not h.amp and h.model["layers"]["0"]["out_ch"] == 512
    assert h.appearance_dim == 48 and not h.bg_nerf
    cfg = jtrainer.render_config_from_hparams(h)
    jm = jmu.get_nerf(h, IDS)
    jstate = jax_train_state(jax.random.PRNGKey(1), h, jm, None)
    jstep = jax.jit(jtrainer.make_train_step(
        jm, None, h, cfg, jtrainer.SceneInfo(None, None), mip=True))

    tm = tmu.get_nerf(h, IDS, device="cpu")
    bridge.load_jax_state(tm, None, jax.tree_util.tree_map(
        np.asarray, jstate.params))
    tstate = ttrainer.create_train_state(h, tm, None, device="cpu")
    tstep = ttrainer.make_train_step(
        h, ttrainer.render_config_from_hparams(h), ttrainer.SceneInfo(),
        mip=True, device="cpu")
    for i in range(2):
        batch = _batch(i)
        jstate, jmet = jstep(jstate, to_jax(batch))
        tstate, tmet = tstep(tstate, batch)
        assert float(tmet["finite"]) == 1.0
        assert sorted(jmet) == sorted(tmet)
        for k in jmet:
            a, b = float(tmet[k]), float(jmet[k])
            assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (i, k, a, b)
        ref = jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jstate.params))
        out = jax.tree_util.tree_leaves(
            bridge.export_jax_state(tstate.model, None))
        assert len(ref) == len(out)
        for (path, b), a in zip(ref, out):
            err = float(np.abs(np.asarray(a) - b).max())
            scale = max(1.0, float(np.abs(b).max()))
            assert err <= 1e-4 * scale, (i, jax.tree_util.keystr(path), err)
    assert tstate.step == int(jstate.step) == 2
    assert isinstance(tstate.model.embedding_a.weight, torch.nn.Parameter)
