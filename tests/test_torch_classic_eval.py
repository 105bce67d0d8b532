"""The port's classic-NeRF eval (``Runner.eval_nerf`` through
``eval_nerf_moe``) vs the JAX package's on the synthetic blender and llff
scenes of tests/test_torch_classic_runner.py, on the CPU, from one JAX
step-0 checkpoint each: the test split's metrics agree (PSNR 1e-4 dB, SSIM
1e-5, LPIPS 1e-4 relative) with the same file set and metric keys.
"""
import copy

import pytest

from switch_nerf_tpu import runner as jrunner
from switch_nerf_torch import eval_nerf_moe as teval
from tests.test_torch_bungee_runner import files, keys
from tests.test_torch_classic_runner import (checkpoints,  # noqa: F401
                                             classic_hparams, scenes)
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401


@pytest.mark.parametrize("kind", ["blender", "llff"])
def test_eval_nerf_matches_jax(scenes, checkpoints, kind, tmp_path):
    h = classic_hparams(kind, scenes / kind, tmp_path / "j")
    h.ckpt_path = str(checkpoints[kind])
    jmeans = jrunner.Runner(h).eval_nerf()
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
    assert keys(texp / "test_images_0" / "metrics.txt") == \
        keys(jexp / "test_images_0" / "metrics.txt")
