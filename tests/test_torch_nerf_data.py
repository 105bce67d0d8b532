"""The port's classic-NeRF data (``datasets/nerf_data``) vs the JAX
package's, on the CPU, on a synthetic Bungee scene the test writes
(poses_enu.json and 17 PNGs; every 16th image held out).

The port decodes with PIL and shrinks with a numpy area resample where the
JAX package uses OpenCV's INTER_AREA (OpenCV is not on the card's machine):
float32 images agree with cv2 to 1e-6 (the block mean summed in another
order), uint8 images exactly. Rays, near/far and radii agree to 1e-6 (the
same float32 arithmetic); the splits, and the train batches for a seed,
are equal.
"""
import cv2
import numpy as np
import pytest

from switch_nerf_tpu.config import get_nerf_dataset_args
from switch_nerf_tpu.datasets import nerf_data as jnd
from switch_nerf_torch.datasets import nerf_data as tnd
from switch_nerf_torch.datasets.nerf_data.ray_utils import (area_downsample,
                                                            get_rays)
from switch_nerf_tpu.datasets.nerf_data.ray_utils import get_rays as jget_rays
from tests.torch_port_helpers import make_bungee_scene, tiny_bungee_hparams


@pytest.mark.parametrize("factor", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_area_downsample_matches_cv2_inter_area(factor, dtype):
    rng = np.random.default_rng(factor)
    img = rng.uniform(0, 255, (36, 48, 3))
    img = img.astype(np.uint8) if dtype == np.uint8 \
        else (img / 255.0).astype(np.float32)
    ref = cv2.resize(img, (48 // factor, 36 // factor),
                     interpolation=cv2.INTER_AREA)
    out = area_downsample(img, factor)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if dtype == np.uint8:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_area_downsample_refuses_a_partial_block():
    with pytest.raises(ValueError):
        area_downsample(np.zeros((10, 12, 3), np.float32), 3)


def test_get_rays_matches_jax():
    k = np.array([[30.0, 0, 12.5], [0, 31.0, 9.5], [0, 0, 1]], np.float32)
    c2w = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    for a, b in zip(get_rays(19, 25, k, c2w), jget_rays(19, 25, k, c2w)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def scene_args(tmp_path_factory):
    root = make_bungee_scene(tmp_path_factory.mktemp("bungee"))
    return get_nerf_dataset_args(tiny_bungee_hparams(root, "unused"))


@pytest.fixture(scope="module")
def datasets(scene_args):
    return jnd.NeRFDataset(scene_args), tnd.NeRFDataset(scene_args)


def test_bungee_dataset_matches_jax(datasets):
    jd, td = datasets
    for name in ("i_train", "i_val", "i_test"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    assert list(td.i_test) == [0, 16] and len(td.i_train) == 15
    assert (td.H, td.W) == (jd.H, jd.W) == (12, 16)
    for name in ("K", "poses", "scene_origin"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    assert td.hwf == jd.hwf and td.scene_scaling_factor == \
        jd.scene_scaling_factor and td.scale_split == jd.scale_split
    np.testing.assert_allclose(td.images, jd.images, rtol=0, atol=1e-6)
    for name in ("rays", "radii", "rays_train", "rgbs_train", "radii_train",
                 "rays_test", "rgbs_test", "radii_test"):
        a, b = getattr(td, name), getattr(jd, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)
    assert np.isfinite(td.rays).all() and (td.rays[..., 6] > 0).all() \
        and (td.rays[..., 7] > td.rays[..., 6]).all()


def test_bungee_views_and_batches_match_jax(datasets):
    jd, td = datasets
    for split in ("NeRFDatasetVal", "NeRFDatasetTest"):
        jv, tv = getattr(jnd, split)(jd), getattr(tnd, split)(td)
        assert len(jv) == len(tv) == 2
        for i in range(2):
            a, b = tv[i], jv[i]
            assert sorted(a) == sorted(b) and a["img_i"] == b["img_i"]
            for k in ("rays", "rgbs", "radii"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)
    jt = jnd.NeRFDatasetTrain(jd, seed=7)
    tt = tnd.NeRFDatasetTrain(td, seed=7)
    assert len(jt) == len(tt) == 15 * 12 * 16
    per_epoch = len(tt) // 64
    for it in (0, 1, per_epoch - 1, per_epoch, 3 * per_epoch + 2):
        a, b = tt.get_batch(it, 64), jt.get_batch(it, 64)
        assert sorted(a) == sorted(b) == ["radii", "rays", "rgbs"]
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)
