"""The coarse-only classic render (--fine_samples 0: the coarse samples
composited, no fine pass) and the per-sample introspection outputs
(--return_pts, --return_pts_rgb, --return_pts_alpha, --return_sigma,
--return_alpha) in the port vs the JAX package, on the CPU, on the
synthetic scenes of tests/test_torch_classic_runner.py.

Coarse-only training through both runners from one JAX checkpoint: every
leaf within 1e-4 (the rule of tests/test_torch_classic_runner.py). An SH
model's eval step (--sh_deg 1, a 12-wide colour head, the published 10 xyz
PE frequencies) with every introspection output on, with a fine pass and
coarse-only: each output within 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import train_nerf_moe as jtrain
from switch_nerf_tpu import trainer as jtrainer
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import bridge
from switch_nerf_torch import train_nerf_moe as ttrain
from switch_nerf_torch import trainer as ttrainer
from switch_nerf_torch.models import model_utils as tmu
from tests.test_torch_bungee_runner import assert_states_close, read_step
from tests.test_torch_classic_runner import (SCENES, classic_hparams,
                                             scenes)  # noqa: F401
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_train_state
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401


def test_coarse_only_matches_jax(scenes, tmp_path):
    """One epoch (3 steps) of coarse-only training through both runners."""
    kind = "blender"
    h = classic_hparams(kind, scenes / kind, "unused")
    h.fine_samples = 0
    h.coarse_samples = 17
    state = jax_train_state(
        jax.random.PRNGKey(1), h, jmu.get_nerf(h, SCENES[kind]), None)
    jckpt.save_checkpoint(tmp_path / "c0", state)
    h.ckpt_path = str(tmp_path / "c0" / "0")
    h.exp_name = str(tmp_path / "j")
    jtrain.main(h)
    ht = copy.copy(h)
    ht.exp_name = str(tmp_path / "t")
    assert ttrain.main(ht, device="cpu").step == 3
    got, _ = read_step(tmp_path / "t" / "0" / "models", 3)
    want, _ = read_step(tmp_path / "j" / "0" / "models", 3)
    assert_states_close(got, want, 1e-4)



def test_return_outputs_match_jax(scenes):
    """An SH model (--sh_deg 1, a 12-wide colour head) through both eval
    steps with every per-sample output on, fine pass and coarse-only."""
    h = classic_hparams("llff", scenes / "llff", "unused")
    h.pos_xyz_dim = 10
    h.sh_deg = 1
    h.model["layers"]["color"]["out_ch"] = 12
    for flag in ("return_pts", "return_pts_rgb", "return_pts_alpha",
                 "return_sigma", "return_alpha"):
        setattr(h, flag, True)
    rng = np.random.default_rng(2)
    o = rng.normal(size=(64, 3)) * 0.1
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((64, 1), 0.2), np.full((64, 1), 2.0)],
                          -1).astype(np.float32)
    for fine in (9, 0):
        h.fine_samples = fine
        jm = jmu.get_nerf(h, 9)
        state = jax_train_state(jax.random.PRNGKey(3), h, jm, None)
        tm = tmu.get_nerf(h, 9, device="cpu")
        bridge.load_jax_state(tm, None,
                              jax.tree_util.tree_map(np.asarray,
                                                     state.params))
        scene = jtrainer.SceneInfo(None, None)
        want = jtrainer.make_eval_step(
            jm, None, h, jtrainer.render_config_from_hparams(h), scene)(
                state.params, {"rays": jnp.asarray(rays)})
        got = ttrainer.make_eval_step(
            tm, None, h, ttrainer.render_config_from_hparams(h),
            ttrainer.SceneInfo(None, None), device="cpu")({"rays": rays})
        typ = "fine" if fine else "coarse"
        names = ["pts_coarse", "pts_rgb_coarse", "pts_alpha_coarse",
                 "sigma_coarse", "alpha_coarse", f"rgb_{typ}",
                 f"depth_{typ}"]
        assert set(names) <= set(got) and set(got) == set(want)
        for k in names:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
