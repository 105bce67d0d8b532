"""The plain reference against the program's CPU path at tiny widths.

With --no_amp the program computes in float32 on the CPU with its kernels'
plain versions and draws the same numbers from the same generator, so
one run of each tiny cell must read gaps at float32's rounding: the
Building train step (padded routing, background NeRF) and the Building
render requests (no-drop routing).

    python -m pytest portbench/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts portbench/ on the path)
from harness import core, train
import run as portbench_run
from reference import nets


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(core, "CACHE", tmp_path / "cache")


def _run(kind, amp=False, hooks=None, seed=2 ** 31 + 7):
    return portbench_run.run_cell(tiny.cell(kind, amp), seed, 0.5, False,
                                  torch.device("cpu"), hooks=hooks)


def test_train_steps_match_the_program_in_fp32():
    """The median leaf's first gradient agrees to float32's rounding. The
    worst leaf reads up to 5.3e-4 on this seed's batches (the background
    NeRF's deep layers, bg.xyz_encoding_3-4; 2e-6 to 1.3e-5 on four other
    seeds; 2.4e-4 with no token dropped, so no routing tie): the bound is
    1e-3 there."""
    out = _run("train")
    c = out["checks"]
    assert out["correct"]
    assert c["loss_gap"]["value"] < 1e-5
    assert c["_readings"]["grad_gap_median_leaf"] < 1e-5
    assert c["grad_gap"]["value"] < 1e-3
    assert c["change_gap_median"]["value"] < 1e-4
    r = c["_readings"]
    # this seed's batches leave two background leaves under the rule's
    # 1e-3 of the median leaf's gradient; every foreground leaf is compared
    assert len(r["program_loss"]) == 3
    assert not [k for k in r["leaves_left_out"] if k.startswith("fg.")]


def test_render_requests_match_the_program_in_fp32():
    out = _run("render")
    assert out["correct"]
    assert out["checks"]["rgb_gap"]["value"] < 1e-6
    assert out["checks"]["rgb_mean_gap"]["value"] < 1e-6
    assert out["checks"]["rgb_share_wrong"]["value"] == 0.0
    assert out["run"]["attempted"] >= 1


def test_control_reads_above_the_program_in_bf16():
    """The fp8 control departs from the float32 reference more than the
    program's bf16 does, in the loss and the first gradient."""
    c = _run("train", amp=True, hooks={"control": True})["checks"]
    ctrl = c["_control"]
    assert ctrl["loss_gap"]["value"] > 3 * c["loss_gap"]["value"]
    assert ctrl["grad_gap"]["value"] > c["grad_gap"]["value"]


def test_weights_are_the_seed_s_and_named_as_the_program_names_them():
    cfg = tiny.config("building")
    spec = nets.moe_spec(cfg, 8)
    a = nets.draw_weights(spec, torch.Generator().manual_seed(5), "cpu")
    b = nets.draw_weights(spec, torch.Generator().manual_seed(5), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    from switch_nerf_torch.models.model_utils import get_nerf
    h = core.port_hparams(cfg, ["--exp_name", "x", "--dataset_path", "y"])
    model = get_nerf(h, 8, device="cpu")
    core.load_weights(model, a)
    assert torch.equal(model.layer_0.experts.w0, a["layer_0.experts.w0"])


def test_the_seed_picks_the_batches():
    """The chunks are the same in every checkout; the seed picks the start
    chunk and the batch order: one seed twice gives the same batches,
    another seed others."""
    c = tiny.cell("train")

    def first(seed):
        b = train.build(c, seed, torch.device("cpu"))
        batch = train.Feed(b["dataset"], c["traffic"]["batch"]).next()
        b["dataset"].close()
        return batch["rays"]
    a = first(2 ** 33 + 5)
    assert np.array_equal(a, first(2 ** 33 + 5))
    assert not np.array_equal(a, first(2 ** 33 + 6))
