"""Scene decomposition of a classic-NeRF (Bungee) scene:
``Runner.eval_points_nerf`` through ``switch_nerf_torch.eval_points``
against the JAX package's, on the CPU.

A reference-layout checkpoint of the tiny Bungee config (mip, 4 experts)
with random weights, converted by the port, serves the 17-image synthetic
scene's two held-out images (each 16 x 12 at the scale factor's 3):
coarse and fine points of every sample with the segmentation sets, in
no-drop dispatch and with --moe_test_batch. The mip model takes each point
with the fixed 1e-6 covariance. The files are the JAX package's, to
tests/test_torch_points.py's bounds: names, headers and colours byte for
byte, coordinates to the last rounding.
"""
import pytest

from switch_nerf_tpu import runner as jrunner
from switch_nerf_torch import convert_torch_ckpt as tconvert
from switch_nerf_torch import eval_points as teval_points
from tests.test_torch_points import assert_same_clouds
from tests.torch_port_helpers import (make_bungee_scene, tiny_bungee_hparams,
                                      write_reference_pt)
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401

N_IMAGES = 17


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_bungee_scene(tmp_path_factory.mktemp("bungee"))


def hp(scene, exp, **over):
    h = tiny_bungee_hparams(scene, exp)
    h.render_test_points_typ = ["coarse", "fine"]
    h.render_test_points_image_num = 2
    h.return_pts_class_seg = True
    for k, v in over.items():
        setattr(h, k, v)
    return h


@pytest.fixture(scope="module")
def checkpoint(scene, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    write_reference_pt(hp(scene, tmp / "e"), N_IMAGES, tmp / "ref.pt",
                       seed=13)
    return tconvert.main(hp(scene, tmp / "e", torch_ckpt=str(tmp / "ref.pt"),
                            out_ckpt=str(tmp / "out")), device="cpu")


@pytest.mark.parametrize("mode", ["nodrop", "padded"])
def test_eval_points_nerf_writes_jax_files(mode, scene, checkpoint,
                                           tmp_path):
    over = dict(ckpt_path=str(checkpoint), moe_test_batch=mode == "padded")
    written = teval_points.main(hp(scene, tmp_path / "t", **over),
                                device="cpu")
    jwritten = jrunner.Runner(hp(scene, tmp_path / "j",
                                 **over)).eval_points_nerf()
    assert sorted(p.name for p in written) == sorted(p.name
                                                     for p in jwritten)
    names = {p.name for p in written}
    assert {"000_coarse_pts_rgba.ply", "001_fine_top_0_alpha_exp_3.ply",
            "001_fine_top_0.ply"} <= names
    worst = assert_same_clouds(tmp_path / "t" / "0" / "eval_points",
                               tmp_path / "j" / "0" / "eval_points")
    print(f"{mode}: coordinates within {worst} of the point's norm")
