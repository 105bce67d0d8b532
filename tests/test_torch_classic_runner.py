"""The port's classic-NeRF runner on the classic scenes (``Runner.
train_nerf`` / ``eval_nerf`` through ``train_nerf_moe`` / ``eval_nerf_moe``)
vs the JAX package's, on the CPU, at the tiny Bungee graph switched to the
classic (non-mip) NeRFMoE and renderer: a synthetic blender scene (white
background, 32x32 RGBA) and a synthetic llff scene (NDC rays, LANCZOS
factor 4: 12x9), no-drop MoE dispatch, 9 + 9 samples.

Both runners start from one JAX step-0 checkpoint and train one epoch
(3 and 2 steps) in 4,096-point model chunks (no-drop routing: the
chunk moves no token), perturb 0 (the two packages draw from different
generators), with 4 xyz PE frequencies: at the published 10 the gradients
of the stem's top-frequency rows are ~4e-8, near Adam's eps (1e-8), and
float32 summation-order noise in them (4e-5 of the leaf's largest
gradient, measured) moves Adam's first update of 3 of the stem's elements
by ~0.4 lr (1.5e-3 of the leaf); with 4 every leaf agrees within 2e-5 at
the last step. The published 10 is held in the forward (the SH eval step
below; points bit-equal, rgb 3.6e-7). Every parameter and Adam moment is held to 1e-4 of its
leaf's largest entry (1e-4 * max(1, largest) for the moments), the
tolerance of the Adam-amplified runner steps (tests/test_torch_bungee_
runner.py). Eval: tests/test_torch_classic_eval.py; the coarse-only render and the
introspection outputs: tests/test_torch_classic_coarse.py.
"""
import copy

import jax
import pytest

from chip_smoke import make_blender_scene, make_llff_scene
from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import train_nerf_moe as jtrain
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import train_nerf_moe as ttrain
from tests.test_torch_bungee_runner import assert_states_close, read_step
from tests.torch_port_helpers import jax_train_state, tiny_bungee_hparams
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401

SCENES = {"blender": 5, "llff": 9}      # images in each scene


def classic_hparams(kind, root, exp):
    """tiny_bungee_hparams switched to the classic NeRFMoE and renderer on
    a blender (white background) or llff (NDC) scene."""
    h = tiny_bungee_hparams(root, exp)
    h.dataset_type = kind
    h.use_mip = False
    h.nerfmoe_class_name = "NeRFMoE"
    h.training_step_fn = "_training_step_nerf"
    h.scale_factor = 1
    h.perturb = 0.0
    h.pos_xyz_dim = 4       # module docstring: the published 10 in eval only
    h.model_chunk_size = 4096
    if kind == "blender":
        h.white_bkgd = True
        h.batch_size = 1024            # 3 x 32 x 32 train rays: 3 steps
    else:
        h.llff_factor = 4
        h.llffhold = 8                 # images 0 and 8 held out
        h.batch_size = 376             # 7 x 12 x 9 train rays: 2 steps
    h.num_epochs = 1
    h.ckpt_interval = 2
    h.i_print = 1
    return h


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("classic")
    make_blender_scene(root / "blender", 0, side=32)
    make_llff_scene(root / "llff", 1, w=48, h=36, n=SCENES["llff"])
    return root


@pytest.fixture(scope="module")
def checkpoints(scenes, tmp_path_factory):
    """A JAX step-0 checkpoint of each scene's model."""
    out = {}
    for kind in SCENES:
        h = classic_hparams(kind, scenes / kind, "unused")
        state = jax_train_state(
            jax.random.PRNGKey(0), h, jmu.get_nerf(h, SCENES[kind]), None)
        root = tmp_path_factory.mktemp(f"ckpt_{kind}")
        jckpt.save_checkpoint(root, state)
        out[kind] = root / "0"
    return out


@pytest.mark.parametrize("kind", ["blender", "llff"])
def test_train_nerf_matches_jax(scenes, checkpoints, kind, tmp_path):
    steps = 3 if kind == "blender" else 2
    h = classic_hparams(kind, scenes / kind, tmp_path / "j")
    h.ckpt_path = str(checkpoints[kind])
    jtrain.main(h)
    ht = copy.copy(h)
    ht.exp_name = str(tmp_path / "t")
    state = ttrain.main(ht, device="cpu")
    assert state.step == steps
    tmodels, jmodels = (tmp_path / w / "0" / "models" for w in "tj")
    assert sorted(p.name for p in tmodels.iterdir()) == \
        sorted(p.name for p in jmodels.iterdir()) == \
        sorted({"2", str(steps)})
    got, gextra = read_step(tmodels, steps)
    want, wextra = read_step(jmodels, steps)
    assert_states_close(got, want, 1e-4)
    assert gextra["host_iteration"] == wextra["host_iteration"] == steps
    log = (tmp_path / "t" / "0" / "log.txt").read_text()
    assert f"iter {steps}/{steps} " in log and "coarse_loss=" not in log
