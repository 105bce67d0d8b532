"""The port's classic-NeRF loaders (``datasets/nerf_data``: llff, blender,
LINEMOD, deepvoxels, gigapixel and the ``NeRFDataset`` branches) vs the JAX
package's, on the CPU, on synthetic scenes in each dataset's layout written
by the test.

Everything the two packages compute in the same float32 (or float64)
arithmetic is held within 1e-6: rays (NDC and not), rgbs, near/far, K, hwf,
poses and render poses; the splits and the train batches for a seed are
equal. The JAX package shrinks with OpenCV's INTER_AREA where the port
uses ``area_downsample`` (``--scale_factor`` and the half_res branches):
those images agree within 1e-6 too (a block mean summed in another order).
llff's LANCZOS fallback is PIL's in both.
"""
import argparse

import numpy as np
import pytest
from PIL import Image

from chip_smoke import make_blender_scene, make_llff_scene, smooth_image
from switch_nerf_tpu.config import get_nerf_dataset_args
from switch_nerf_tpu.datasets import nerf_data as jnd
from switch_nerf_torch.config import (get_nerf_dataset_args as
                                      tget_nerf_dataset_args)
from switch_nerf_torch.config import get_opts_nerf, parse_args
from switch_nerf_torch.datasets import nerf_data as tnd

TOL = dict(rtol=1e-6, atol=1e-6)


def make_linemod_scene(root, side=32, seed=0):
    """A synthetic LINEMOD scene in `root`: transforms_{train,val,test}.json
    (frames with file_path, transform_matrix and intrinsic_matrix; near and
    far in train and test) and side x side RGBA PNGs, 3 + 2 + 2, the second
    train image a palette PNG with a transparent index (which imageio, and
    the loaders, expand to RGBA)."""
    import json
    from pathlib import Path
    from switch_nerf_torch.datasets.nerf_data.load_blender import \
        pose_spherical
    root = Path(root)
    rng = np.random.default_rng(seed)
    k = [[0.9 * side, 0.0, 0.47 * side], [0.0, 0.9 * side, 0.53 * side],
         [0.0, 0.0, 1.0]]
    for split, n in (("train", 3), ("val", 2), ("test", 2)):
        (root / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(n):
            rgb = np.asarray(smooth_image(rng, side, side))
            alpha = rng.integers(0, 256, (side, side, 1), dtype=np.uint8)
            img = Image.fromarray(np.concatenate([rgb, alpha], -1))
            name = f"{split}/{i:04d}.png"
            if split == "train" and i == 1:
                pal = Image.fromarray(rgb).quantize(16)
                pal.save(root / name, transparency=0)
            else:
                img.save(root / name)
            frames.append({"file_path": name, "intrinsic_matrix": k,
                           "transform_matrix": pose_spherical(
                               rng.uniform(-180, 180), -30.0, 1.2).tolist()})
        meta = {"frames": frames}
        if split != "val":
            meta.update(near=float(rng.uniform(0.3, 0.6)),
                        far=float(rng.uniform(1.7, 2.2)))
        (root / f"transforms_{split}.json").write_text(json.dumps(meta))
    return root


def make_deepvoxels_scene(root, shape="cube", seed=0, views=(3, 2, 2)):
    """A synthetic DeepVoxels scene in `root`: {train,validation,test}/
    <shape>/{rgb/*.png, pose/*.txt} (512x512 images, 4x4 OpenCV-convention
    c2w on a radius-4 hemisphere) and train/<shape>/intrinsics.txt."""
    from pathlib import Path
    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in zip(("train", "validation", "test"), views):
        base = root / split / shape
        (base / "rgb").mkdir(parents=True, exist_ok=True)
        (base / "pose").mkdir(parents=True, exist_ok=True)
        for i in range(n):
            smooth_image(rng, 512, 512).save(base / "rgb" / f"{i:06d}.png")
            th, ph = rng.uniform(0, 2 * np.pi), rng.uniform(0.2, 1.2)
            eye = 4.0 * np.array([np.cos(th) * np.cos(ph),
                                  np.sin(th) * np.cos(ph), np.sin(ph)])
            fwd = -eye / np.linalg.norm(eye)          # OpenCV: +z forward
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            c2w = np.eye(4)
            c2w[:3, :4] = np.stack([right, down, fwd, eye], 1)
            np.savetxt(base / "pose" / f"{i:06d}.txt", c2w.reshape(1, 16))
    (root / "train" / shape / "intrinsics.txt").write_text(
        "480.0 256.0 250.0 0.\n0. 0. 0.\n1.\n1.\n512 512\n")
    return root



def loader_args(kind, root, **over):
    """get_nerf_dataset_args of a parsed --data_type nerf command line."""
    h = parse_args(get_opts_nerf(), [
        "--data_type", "nerf", "--dataset_type", kind, "--dataset_path",
        str(root), "--exp_name", "unused"])
    for k, v in over.items():
        setattr(h, k, v)
    a, b = get_nerf_dataset_args(h), tget_nerf_dataset_args(h)
    assert vars(a) == vars(b)
    return b


def assert_same(td, jd):
    for name in ("i_train", "i_val", "i_test"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name),
                                      err_msg=name)
    assert (td.H, td.W) == (jd.H, jd.W) and td.near == jd.near \
        and td.far == jd.far
    np.testing.assert_allclose(td.hwf, jd.hwf, **TOL)
    for name in ("K", "poses", "render_poses", "images", "rays",
                 "rays_train", "rgbs_train", "rays_val", "rgbs_val",
                 "rays_test", "rgbs_test"):
        a, b = getattr(td, name), getattr(jd, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    assert td.radii is None and np.isfinite(td.rays).all()
    # the views: no radii, the same samples and batches
    for split in ("NeRFDatasetVal", "NeRFDatasetTest"):
        tv, jv = getattr(tnd, split)(td), getattr(jnd, split)(jd)
        assert len(tv) == len(jv)
        for i in range(len(tv)):
            a, b = tv[i], jv[i]
            assert sorted(a) == sorted(b) == ["img_i", "rays", "rgbs"]
            assert a["img_i"] == b["img_i"]
            for k in ("rays", "rgbs"):
                np.testing.assert_allclose(a[k], b[k], **TOL)
    tt, jt = tnd.NeRFDatasetTrain(td, seed=3), jnd.NeRFDatasetTrain(jd, seed=3)
    assert len(tt) == len(jt)
    for it in (0, 1, len(tt) // 50 + 1):
        a, b = tt.get_batch(it, 50), jt.get_batch(it, 50)
        assert sorted(a) == sorted(b) == ["rays", "rgbs"]
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **TOL)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("classic")
    make_blender_scene(root / "blender", 0, side=32,
                       splits=(("train", 3), ("val", 4), ("test", 5)))
    make_llff_scene(root / "llff", 1, w=48, h=36, n=9, pre_factor=2)
    make_llff_scene(root / "llff_sph", 2, w=48, h=36, n=6, spheric=True)
    make_linemod_scene(root / "linemod")
    make_deepvoxels_scene(root / "dv", shape="greek")
    return root


@pytest.mark.parametrize("ndc,factor,spheric,hold", [
    (True, 4, False, 8),        # NDC, the LANCZOS fallback (no images_4)
    (False, 2, False, 8),       # near/far from the bounds, images_2 read
    (True, 1, False, 0),        # the view closest to the average held out
    (False, 4, True, 3),        # spherified poses and render path
    (True, 2, False, 4),        # --scale_factor 2 on top of the factor
])
def test_llff_matches_jax(scenes, ndc, factor, spheric, hold):
    root = scenes / ("llff_sph" if spheric else "llff")
    args = loader_args("llff", root, no_ndc=not ndc, llff_factor=factor,
                       spheric_poses=spheric, llffhold=hold,
                       scale_factor=2 if hold == 4 else 1)
    td, jd = tnd.NeRFDataset(args), jnd.NeRFDataset(args)
    assert_same(td, jd)
    assert td.images.shape[1:3] == (36 // factor // args.scale_factor,
                                    48 // factor // args.scale_factor)
    if ndc:
        assert (td.near, td.far) == (0.0, 1.0)
    else:
        assert 0 < td.near < td.far


def test_llff_reads_the_pre_downscaled_dir(scenes):
    """images_2/ holds other pictures than images/ shrunk: the loader
    reads them, not a resize."""
    from switch_nerf_torch.datasets.nerf_data.load_llff import _load_images
    imgs = _load_images(str(scenes / "llff"), 2)
    first = np.asarray(Image.open(scenes / "llff" / "images_2" /
                                  "IMG_0000.png"), np.float32) / 255.0
    np.testing.assert_array_equal(imgs[0], first)


@pytest.mark.parametrize("white,testskip,sf", [
    (True, 1, 1), (False, 2, 1), (True, 3, 2), (False, 0, 4)])
def test_blender_matches_jax(scenes, white, testskip, sf):
    args = loader_args("blender", scenes / "blender", white_bkgd=white,
                       testskip=testskip, scale_factor=sf)
    td, jd = tnd.NeRFDataset(args), jnd.NeRFDataset(args)
    assert_same(td, jd)
    skip = testskip or 1
    assert [len(td.i_train), len(td.i_val), len(td.i_test)] == \
        [3, len(range(0, 4, skip)), len(range(0, 5, skip))]
    assert (td.near, td.far) == (2.0, 6.0) and td.render_poses.shape == \
        (40, 4, 4)
    if white:                            # alpha 0 in the corners
        np.testing.assert_allclose(td.images[0, 0, 0], 1.0, atol=1e-6)


@pytest.mark.parametrize("white", [True, False])
def test_linemod_matches_jax(scenes, white):
    args = loader_args("LINEMOD", scenes / "linemod", white_bkgd=white,
                       testskip=1)
    td, jd = tnd.NeRFDataset(args), jnd.NeRFDataset(args)
    assert_same(td, jd)
    assert td.K[0, 2] != 0.5 * td.W          # its own K, not the centre
    assert td.near == 0.0 and td.far == 3.0  # floor(min) / ceil(max)


def test_deepvoxels_matches_jax(scenes):
    args = loader_args("deepvoxels", scenes / "dv", testskip=1,
                       scale_factor=8, shape="greek")
    td, jd = tnd.NeRFDataset(args), jnd.NeRFDataset(args)
    assert_same(td, jd)
    assert (td.H, td.W) == (64, 64)
    assert abs((td.near + td.far) / 2 - 4.0) < 1e-5


@pytest.mark.parametrize("kind", ["blender", "LINEMOD"])
def test_half_res_matches_cv2(scenes, kind):
    """half_res is reached by calling a loader (get_nerf_dataset_args
    always sets it off, as JAX's does): the port's area resample against
    JAX's cv2 INTER_AREA."""
    from switch_nerf_torch.datasets.nerf_data import (load_blender,
                                                       load_LINEMOD)
    from switch_nerf_tpu.datasets.nerf_data import load_blender as jb
    from switch_nerf_tpu.datasets.nerf_data import load_LINEMOD as jl
    if kind == "blender":
        t = load_blender.load_blender_data(str(scenes / "blender"), True, 2)
        j = jb.load_blender_data(str(scenes / "blender"), True, 2)
    else:
        t = load_LINEMOD.load_LINEMOD_data(str(scenes / "linemod"), True, 1)
        j = jl.load_LINEMOD_data(str(scenes / "linemod"), True, 1)
    assert t[0].shape[1:3] == (16, 16) and t[0].dtype == j[0].dtype
    np.testing.assert_allclose(t[0], j[0], **TOL)
    for a, b in zip(t[1:], j[1:]):
        if isinstance(a, list) and isinstance(a[0], np.ndarray):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64), **TOL)


def test_ndc_rays_matches_jax():
    from switch_nerf_torch.datasets.nerf_data.ray_utils import ndc_rays
    from switch_nerf_tpu.datasets.nerf_data.ray_utils import \
        ndc_rays as jndc
    rng = np.random.default_rng(4)
    o = rng.normal(size=(7, 5, 3)).astype(np.float32)
    d = rng.normal(size=(7, 5, 3)).astype(np.float32)
    d[..., 2] = -np.abs(d[..., 2]) - 0.1
    for a, b in zip(ndc_rays(19, 25, 30.0, 1.0, o, d),
                    jndc(19, 25, 30.0, 1.0, o, d)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [1, 0.37, 3])
def test_gigapixel_matches_jax(tmp_path, scale):
    from switch_nerf_torch.datasets.nerf_data.load_gigapixel import \
        load_gigapixel_data
    from switch_nerf_tpu.datasets.nerf_data.load_gigapixel import \
        load_gigapixel_data as jload
    path = tmp_path / "giga.png"
    smooth_image(np.random.default_rng(5), 61, 47).save(path)
    for a, b in zip(load_gigapixel_data(path, scale), jload(path, scale)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_unknown_dataset_type_raises():
    args = argparse.Namespace(dataset_type="nope")
    with pytest.raises(NotImplementedError):
        tnd.NeRFDataset(args)
