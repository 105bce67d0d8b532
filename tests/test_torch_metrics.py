"""The port's image metrics and host helpers vs the JAX package's, on the
CPU: psnr/psnr_mask to 1e-4 dB and ssim/ssim_mask to 1e-5 on 37x53
images, visualize_scalars and voc_palette equal, DictAverageMeter equal,
the LPIPS environment contract, and the crash report / TensorBoard writer.
"""
import json
import logging

import numpy as np
import pytest
import torch

from switch_nerf_tpu import metrics as jm
from switch_nerf_tpu.utils import meters as jmeters
from switch_nerf_tpu.utils import visualize as jvis
from switch_nerf_torch import metrics as tm
from switch_nerf_torch.utils import crash as tcrash
from switch_nerf_torch.utils import logger as tlogger
from switch_nerf_torch.utils import meters as tmeters
from switch_nerf_torch.utils import tb as ttb
from switch_nerf_torch.utils import visualize as tvis


def images(seed, noise):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(37, 53, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, a.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=(37, 53)) > 0.3
    return a, b, mask


@pytest.mark.parametrize("seed,noise", [(0, 0.02), (1, 0.1), (2, 0.4)])
def test_psnr_ssim_match_jax(seed, noise):
    a, b, mask = images(seed, noise)
    for got, want, tol in (
            (tm.psnr(a, b), jm.psnr(a, b), 1e-4),
            (tm.psnr_mask(a, b, mask), jm.psnr_mask(a, b, mask), 1e-4),
            (tm.ssim(a, b, 1.0), jm.ssim(a, b, 1.0), 1e-5),
            (tm.ssim_mask(a, b, 1.0, mask), jm.ssim_mask(a, b, 1.0, mask),
             1e-5)):
        assert abs(got - want) <= tol, (got, want)
    # torch inputs compute on their device and give the same numbers
    assert tm.ssim(torch.from_numpy(a), torch.from_numpy(b), 1.0) == \
        tm.ssim(a, b, 1.0)


def test_ssim_identical_and_small_images():
    a, _, _ = images(3, 0.0)
    assert tm.ssim(a, a, 1.0) == pytest.approx(1.0, abs=1e-5)
    small = a[:4, :3]          # smaller than the 11-tap filter
    assert abs(tm.ssim(small, small[::-1], 1.0)
               - jm.ssim(small, small[::-1], 1.0)) <= 1e-5


@pytest.mark.parametrize("case", ["depth", "zeros", "flat", "rgb_channels",
                                  "rainbow"])
def test_visualize_scalars_matches_jax(case):
    """The port's colormap tables against the JAX package's OpenCV calls
    (INFERNO by default; RAINBOW, --colormap 4, the classic-NeRF default):
    equal bytes."""
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.01, 3.0, (19, 23)).astype(np.float32)
    kw = {}
    if case == "zeros":
        depth[:5] = 0.0
    elif case == "flat":
        depth[:] = 0.7
    elif case == "rgb_channels":
        depth = np.repeat(depth[..., None], 3, -1)
    elif case == "rainbow":
        kw = {"colormap": 4}
    got = tvis.visualize_scalars(depth, **kw)
    want = jvis.visualize_scalars(depth, **kw)
    assert got.dtype == np.uint8 and got.shape == (19, 23, 3)
    np.testing.assert_array_equal(got, want)


def test_voc_palette_matches_jax():
    np.testing.assert_array_equal(tvis.voc_palette(), jvis.voc_palette())
    np.testing.assert_array_equal(tvis.voc_palette(9), jvis.voc_palette(9))


def test_meter_matches_jax():
    t, j = tmeters.DictAverageMeter(), jmeters.DictAverageMeter()
    for vals, n in (({"psnr": 20.0, "ssim": 0.5}, 1),
                    ({"psnr": 22.5}, 3), ({"ssim": 0.25, "x": 1}, 2)):
        t.update(vals, n)
        j.update(vals, n)
    assert t.mean() == j.mean() == t.mean_across_processes()
    t.reset()
    assert t.mean() == {}


def test_lpips_environment_contract(monkeypatch, tmp_path):
    a, b, _ = images(5, 0.1)
    monkeypatch.delenv("SWITCH_NERF_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(tm, "_LPIPS_DEFAULT_PATH", str(tmp_path / "no.npz"))
    assert tm.validate_lpips_setup() is None
    got = tm.lpips(a, b)
    assert sorted(got) == ["alex-substitute", "squeeze-substitute",
                           "vgg-substitute"]
    assert all(np.isfinite(v) and v > 0 for v in got.values())

    monkeypatch.setenv("SWITCH_NERF_LPIPS_SUBSTITUTE", "0")
    assert tm.lpips(a, b) == jm.lpips(a, b) == {
        "vgg": None, "alex": None, "squeeze": None}

    monkeypatch.setenv("SWITCH_NERF_LPIPS_WEIGHTS", str(tmp_path / "gone"))
    for mod in (tm, jm):
        with pytest.raises(FileNotFoundError):
            mod.validate_lpips_setup()


def test_crash_report(monkeypatch, tmp_path):
    path = tmp_path / "err.json"
    monkeypatch.setenv("SWITCH_NERF_ERROR_FILE", str(path))

    @tcrash.cli_entry
    def main():
        raise KeyError("boom")

    with pytest.raises(KeyError):
        main()
    report = json.loads(path.read_text())
    assert report["exc_type"] == "KeyError" and "boom" in report["message"]
    assert "Traceback" in report["traceback"]


def test_logger_and_tensorboard(tmp_path, capsys):
    log = tlogger.setup_logger(None, tmp_path)
    tlogger.main_log("hello log")
    assert "hello log" in (tmp_path / "log.txt").read_text()
    assert tlogger.count_parameters(torch.nn.Linear(3, 4)) == 16
    writer = ttb.SummaryWriter(tmp_path / "tb")
    writer.add_scalar("val/psnr", 12.5, 3)
    writer.add_image("img", np.zeros((4, 5, 3), np.float32), 3)
    writer.flush()
    try:
        import tensorboard  # noqa: F401
    except ImportError:
        assert not (tmp_path / "tb").exists()
    else:
        assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
    for h in list(log.handlers):
        h.close()
        log.removeHandler(h)
    logging.getLogger(None).handlers.clear()
