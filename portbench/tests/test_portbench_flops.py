"""The benchmark's arithmetic, the idle-share union and the guards, on
the CPU.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import json

import pytest
import torch

import tiny  # noqa: F401  (puts portbench/ on the path)
from harness import core, flops
from harness.trace import Trace, gaps, union_length


def _cfg(name):
    return json.loads((tiny.HERE / "configs" / f"{name}.json").read_text())


def test_one_chain_call_by_hand():
    """E 8, C 16,384, M 256, L 7 in bf16: 2 E C M^2 L operations forward;
    x and out (E C M bf16 each) and 7 layers of every expert's W and b."""
    e, c, m, l = 8, 16384, 256, 7
    fwd = flops.chain_fwd(e * c, m, l, 2, e)
    assert fwd["flops"] == 2 * 8 * 16384 * 256 * 256 * 7 == 120259084288
    assert fwd["bytes"] == (2 * (8 * 16384 * 256) * 2
                            + 8 * 7 * (256 * 256 + 256) * 2)
    bwd = flops.chain_bwd(e * c, m, l, 2, e)
    assert bwd["flops"] == 2 * fwd["flops"]
    assert bwd["bytes"] == (3 * 8 * 16384 * 256 * 2
                            + 8 * 7 * (256 * 256 + 256) * (2 + 4))
    # bound by operations: 120.26 GFLOP at 989 TFLOP/s
    assert flops.bound_s([fwd], "bf16") == pytest.approx(
        120259084288 / 989e12)


def test_padded_calls_of_a_building_step():
    """8,192 rays: 16 coarse and 32 fine calls of 131,072 points, each at
    8 x 16,384 slots; under remat each forward twice, one backward."""
    cfg = _cfg("building")
    assert flops.calls(8192 * 256, 131072) == [131072] * 16
    assert flops.capacity_rows(131072, 8, 1.0) == 131072
    counts = flops.chain_counts(cfg, 8192, True, True)
    assert len(counts) == 48 * 3
    assert flops.calls(1000, 300) == [300, 300, 300, 100]


def test_model_flops_a_ray():
    """Building: 768 NeRF-MoE points (the routed expert only) and 384
    background points."""
    b = _cfg("building")
    fg = 2 * (75 * 256 + 256 * 256 * 2 + 256 * 8 + 7 * 256 * 256 + 256
              + 256 * 256 + 331 * 128 + 128 * 3)
    bg = 2 * (100 * 256 + 3 * 256 * 256 + 356 * 256 + 3 * 256 * 256 + 256
              + 256 * 256 + 331 * 128 + 128 * 3)
    assert flops.fg_point_flops(b) == fg
    assert flops.bg_point_flops(b) == bg
    assert flops.ray_flops(b, False) == 768 * fg + 384 * bg
    assert flops.ray_flops(b, True) == 3 * (768 * fg + 384 * bg)


def test_idle_share_counts_overlapping_operations_once():
    ops = [(0.0, 2.0), (1.0, 3.0), (2.5, 4.0), (6.0, 7.0), (6.5, 6.8)]
    assert union_length(ops) == pytest.approx(5.0)
    assert union_length(ops, 1.5, 6.5) == pytest.approx(3.0)
    assert gaps(ops, 0.0, 10.0) == [(4.0, 6.0), (7.0, 10.0)]
    tr = Trace([(s, e, "k") for s, e in ops], [(0.0, 10.0, "step")], [],
               (0.0, 10.0), 1)
    assert tr.busy_s() == pytest.approx(5.0)
    assert tr.idle_by_host() == [["step", pytest.approx(5.0)]]


def test_guard_compares_top_level_names_whole():
    assert core.forbidden_modules(
        ["switch_nerf_tpu.x", "switch_nerf_torch.x", "jax", "jaxlib.xla",
         "flaxen", "optax", "orbax.checkpoint", "numpy"]) == [
        "jax", "jaxlib.xla", "optax", "orbax.checkpoint", "switch_nerf_tpu.x"]


def test_a_run_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(core.CellError):
        core.cuda_device(1)


def test_every_metric_has_its_reader_and_every_cell_its_files():
    b = core.benchmark()
    for m in b["end_to_end"] + b["per_layer"]:
        assert (tiny.HERE / "metrics" / f"{m['name']}.py").exists()
    for w in b["workloads"]:
        c = core.cell(w["name"])
        assert c["limits"] and c["traffic"]["kind"] in ("train", "render")
