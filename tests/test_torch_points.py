"""Scene decomposition on the port (``Runner.eval_points``,
``switch_nerf_torch.eval_points``, ``merge_points``, ``utils/ply.py``)
against the JAX package's, on the CPU.

A reference-layout checkpoint of the tiny Building config with random
weights (so the gates spread over the experts), converted by the port,
serves the 24x16 synthetic scene's two val images: coarse and fine
points, every second sample, with the segmentation sets
(--return_pts_class_seg), in no-drop dispatch and with --moe_test_batch
(the whole 160 x 4-point request in one padded MoE call, whose capacity
sets the drops). The port writes the JAX package's files: the same names,
headers and colours (so the same expert of every point), byte for byte.
The coordinates are not all bit-equal to the jitted JAX program's: XLA's
CPU backend fuses o + d * z into one FMA, so the coarse points differ by
up to one rounding (2^-22 of the point's norm); the same JAX program run
op by op (jax.disable_jit) writes the port's coarse files byte for byte,
which test_unjitted_jax_writes_the_port_coarse_bytes shows. A fine point
is resampled from the coarse CDF, whose last bits follow the model's
outputs (XLA's and PyTorch's CPU matrix products round differently, jit
or not); where that CDF is flat up to the far bound the point moves with
them, up to 2e-3 of its norm (measured 1.8e-3). Its no-drop calls cut into 100-point pieces
write the same clouds as whole ones; the
model's gate returns equal JAX's [S, K] per MoE layer in both dispatch
modes; the port's merge_points merges the port's clouds into the files
the JAX script writes. Two gloo ranks (tests/torch_parallel_worker.py)
each render and write their own image, i % 2, and together write one
process's clouds.
"""
import jax
import numpy as np
import pytest
import torch

from scripts import merge_points as jmerge
from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import runner as jrunner
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_tpu.utils import ply as jply
from switch_nerf_torch import bridge
from switch_nerf_torch import convert_torch_ckpt as tconvert
from switch_nerf_torch import eval_points as teval_points
from switch_nerf_torch import merge_points as tmerge
from switch_nerf_torch import runner as trunner
from switch_nerf_torch.models import model_utils as tmu
from switch_nerf_torch.utils import ply as tply
from tests.torch_port_helpers import (Ranks, jax_train_state, mega_hparams,
                                      with_val_image, write_reference_pt)
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return with_val_image(tmp_path_factory.mktemp("mega"))


def hp(scene, exp, **over):
    h = mega_hparams(scene, exp)
    h.render_test_points_typ = ["coarse", "fine"]
    h.render_test_points_image_num = 2
    h.render_test_points_sample_skip = 2
    h.return_pts_class_seg = True
    for k, v in over.items():
        setattr(h, k, v)
    return h


@pytest.fixture(scope="module")
def checkpoint(scene, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    count = trunner.Runner(hp(scene, tmp / "e"), set_experiment_path=False,
                           device="cpu").appearance_count
    write_reference_pt(hp(scene, tmp / "e"), count, tmp / "ref.pt", seed=11)
    return tconvert.main(hp(scene, tmp / "e", torch_ckpt=str(tmp / "ref.pt"),
                            out_ckpt=str(tmp / "out")), device="cpu"), count


def tree_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*.ply"))}


@pytest.fixture(scope="module")
def exports(scene, checkpoint, tmp_path_factory):
    """Each dispatch mode's eval_points directory, port and JAX."""
    ckpt, _ = checkpoint
    tmp = tmp_path_factory.mktemp("points")
    out = {}
    for mode in ("nodrop", "padded"):
        over = dict(ckpt_path=str(ckpt), moe_test_batch=mode == "padded")
        written = teval_points.main(hp(scene, tmp / f"t_{mode}", **over),
                                    device="cpu")
        jwritten = jrunner.Runner(hp(scene, tmp / f"j_{mode}",
                                     **over)).eval_points()
        out[mode] = (written, jwritten, tmp / f"t_{mode}" / "0" /
                     "eval_points", tmp / f"j_{mode}" / "0" / "eval_points")
    return out


def assert_same_clouds(tdir, jdir):
    """Every PLY of jdir in tdir: the same header and colours, byte for
    byte; coordinates within 2^-22 of the point's norm (coarse) or 2e-3
    (fine), the rest of module docstring's bounds. Returns the largest
    norm-relative coordinate error per typ."""
    got, want = tree_bytes(tdir), tree_bytes(jdir)
    assert sorted(got) == sorted(want)
    worst = {"coarse": 0.0, "fine": 0.0}
    for name, raw in want.items():
        head = raw[:raw.index(b"end_header\n")]
        assert got[name][:len(head)] == head, name
        (x, c), (y, d) = (tply.read_ply_points(r / name)
                          for r in (tdir, jdir))
        np.testing.assert_array_equal(c, d, err_msg=name)
        if not len(y):
            continue
        typ = "fine" if "_fine_" in name else "coarse"
        err = np.abs(x - y) / np.maximum(
            np.linalg.norm(y, axis=-1, keepdims=True), 1.0)
        worst[typ] = max(worst[typ], float(err.max()))
    assert worst["coarse"] <= 2.0 ** -22 and worst["fine"] <= 2e-3, worst
    return worst


@pytest.mark.parametrize("mode", ["nodrop", "padded"])
def test_eval_points_writes_jax_files(mode, exports):
    written, jwritten, tdir, jdir = exports[mode]
    assert sorted(p.name for p in written) == sorted(p.name
                                                     for p in jwritten)
    worst = assert_same_clouds(tdir, jdir)
    print(f"{mode}: coordinates within {worst} of the point's norm")
    assert (tdir / "1" / "001_fine_top_0_alpha_exp_3.ply").exists()
    # 24 x 16 rays x 2 kept samples; the expert sets partition the cloud
    xyz, _ = tply.read_ply_points(tdir / "0" / "000_coarse_pts_rgba.ply")
    assert xyz.shape == (24 * 16 * 2, 3)
    sizes = [tply.read_ply_points(
        tdir / "0" / f"000_coarse_pts_rgba_top_0_exp_{e}.ply")[0].shape[0]
        for e in range(4)]
    assert sum(sizes) == xyz.shape[0] and sum(s > 0 for s in sizes) > 1


def test_unjitted_jax_writes_the_port_coarse_bytes(scene, checkpoint,
                                                   exports, tmp_path):
    """The coarse coordinates' one rounding is XLA's fused o + d * z: JAX's
    eval_points run op by op (one request for the image's 384 rays: no-drop
    routes each token alone) writes every coarse file of val image 0 as
    the port does, byte for byte."""
    ckpt, count = checkpoint
    runner = jrunner.Runner(hp(scene, tmp_path, ckpt_path=str(ckpt),
                               moe_test_batch=False, moe_return_gates=True,
                               render_test_points_typ=["coarse"],
                               render_test_points_image_num=1,
                               image_pixel_batch_size=24 * 16))
    # eval_points' steps, the state loaded (and compiled) outside
    runner.nerf = jmu.get_nerf(runner.hparams, count)
    state = runner._load_eval_state()
    with jax.disable_jit():
        runner._run_validation_points(state)
    got = tree_bytes(exports["nodrop"][2])
    want = tree_bytes(tmp_path / "0" / "eval_points")
    assert len(want) == 15 and all("_coarse_" in k for k in want)
    assert [k for k in want if got[k] != want[k]] == []


def test_nodrop_calls_cut_in_pieces(scene, checkpoint, exports, tmp_path,
                                    monkeypatch):
    """No-drop routes each token alone: 100-point calls (every request's
    640 points in 7 calls) write the same clouds as whole ones: the coarse
    files byte for byte, the fine ones to assert_same_clouds' bounds (the
    CPU's matrix products round a row's sums differently at another row
    count, and the far fine samples carry that last bit)."""
    ckpt, _ = checkpoint
    monkeypatch.setattr(trunner, "POINTS_CALL_ROWS", 100)
    calls = []
    real = trunner.get_nerf

    def counted(*a, **k):
        model = real(*a, **k)
        fwd = model.forward
        model.forward = lambda x, *b, **c: calls.append(len(x)) or fwd(
            x, *b, **c)
        return model
    monkeypatch.setattr(trunner, "get_nerf", counted)
    teval_points.main(hp(scene, tmp_path, ckpt_path=str(ckpt),
                         moe_test_batch=False), device="cpu")
    assert max(calls) == 100
    split, whole = tmp_path / "0" / "eval_points", exports["nodrop"][2]
    worst = assert_same_clouds(split, whole)
    print(f"100-point calls: coordinates within {worst} of the point's norm")
    coarse = [k for k in tree_bytes(whole) if "_coarse_" in k]
    assert [tree_bytes(split)[k] for k in coarse] == [
        tree_bytes(whole)[k] for k in coarse]


@pytest.mark.parametrize("mode", ["nodrop", "padded"])
def test_gate_returns_match_jax(mode, scene, checkpoint):
    """NeRFMoE's moe_gates: one [S, K] per MoE layer, JAX's indices."""
    ckpt, count = checkpoint
    h = hp(scene, "unused", moe_return_gates=True,
           moe_test_batch=mode == "padded")
    jnerf = jmu.get_nerf(h, count)
    state = jax_train_state(jax.random.PRNGKey(0), h, jnerf,
                            jmu.get_bg_nerf(h, count))
    params = jckpt.load_checkpoint(ckpt, state,
                                   restore_rng_states=False)[0].params
    model = tmu.get_nerf(h, count, device="cpu")
    bridge.load_jax_params(model, jax.tree_util.tree_map(np.asarray,
                                                         params["nerf"]))
    rng = np.random.default_rng(2)
    d = rng.normal(size=(300, 3))
    pts = np.concatenate([rng.uniform(-3.0, 3.0, (300, 3)),
                          d / np.linalg.norm(d, axis=-1, keepdims=True),
                          rng.integers(0, count, (300, 1))], -1
                         ).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(pts), train=False)["extras"]["moe_gates"]
    want = jnerf.apply({"params": params["nerf"]}, pts,
                       deterministic=True)["extras"]["moe_gates"]
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) == (300, 1)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert len(np.unique(np.asarray(want[0]))) > 1


def test_merge_points_matches_the_script(exports, tmp_path):
    """The port's merge of the port's clouds, per expert and all-points,
    equals the JAX script's, byte for byte."""
    src = exports["nodrop"][2]
    for expert_num in (4, 0):
        tmerge.merge(src, tmp_path / "t", down_scale=0.5,
                     expert_num=expert_num, typ="fine", seed=3)
        jmerge.merge(src, tmp_path / "j", down_scale=0.5,
                     expert_num=expert_num, typ="fine", seed=3)
    got, want = tree_bytes(tmp_path / "t"), tree_bytes(tmp_path / "j")
    assert sorted(got) == sorted(want) == sorted(
        [f"fine_pts_rgba_exp_{e}.ply" for e in range(4)]
        + ["fine_pts_rgba.ply"])
    assert got == want


def test_ply_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    for ch in (3, 4):
        colors = rng.integers(0, 256, (50, ch)).astype(np.uint8)
        tply.write_ply_points(tmp_path / f"t{ch}.ply", xyz, colors)
        jply.write_ply_points(tmp_path / f"j{ch}.ply", xyz, colors)
        assert (tmp_path / f"t{ch}.ply").read_bytes() == \
            (tmp_path / f"j{ch}.ply").read_bytes()
        x2, c2 = tply.read_ply_points(tmp_path / f"j{ch}.ply")
        np.testing.assert_array_equal(x2, xyz)
        np.testing.assert_array_equal(c2, colors)


def test_two_ranks_write_one_process_clouds(scene, checkpoint, exports,
                                            tmp_path):
    ckpt, _ = checkpoint
    h = hp(scene, tmp_path / "dp", ckpt_path=str(ckpt), moe_test_batch=False)
    outs = Ranks(tmp_path / "job.pkl", [
        {"name": "points", "kind": "eval", "entry": "eval_points",
         "h": h}]).get("points")
    mine = [sorted(p.name for p in o["means"]) for o in outs]
    assert mine[0] and mine[0][0].startswith("000_")
    assert mine[1] and mine[1][0].startswith("001_")
    worst = assert_same_clouds(tmp_path / "dp" / "0" / "eval_points",
                               exports["nodrop"][2])
    print(f"2 ranks: coordinates within {worst} of the point's norm")
