"""The readers of the program's spans (harness/spans.py) on a synthetic
trace, and on a tiny traced training run on the CPU.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import importlib.util

import pytest
import torch

import tiny
from harness import spans
from harness.trace import Trace

MS = 1e-3


def _ops(*ops):
    return [(s * MS, e * MS, n) for s, e, n in ops]


# one training step's spans in milliseconds, read as over two steps (units
# 2); the backward's spans (on the autograd engine's thread) lie inside
# train.backward by time
STEP = _ops(
    (0, 100, "snerf.train.step"),
    (1, 40, "snerf.train.forward"),
    (2, 39, "snerf.render.rays"),
    (3, 20, "snerf.render.coarse"),
    (5, 15, "snerf.model.call"),
    (6, 7, "snerf.moe.gate"),
    (8, 12, "snerf.moe.experts"),
    (21, 38, "snerf.render.fine"),
    (41, 90, "snerf.train.backward"),
    (45, 60, "snerf.remat.recompute"),
    (46, 58, "snerf.model.call"),
    (50, 55, "snerf.moe.experts"),
    (62, 70, "snerf.moe.experts_bwd"),
    (91, 95, "snerf.train.finite"),
    (96, 99, "snerf.train.adam"),
    # host ops that are neither spans nor launches
    (9, 10, "aten::mm"),
    (51, 52, "autograd::engine::evaluate_function: MulBackward0"),
)
LAUNCH_AT = {
    0.5: "train.step", 4: "render.coarse", 6.5: "moe.gate",
    9.5: "moe.experts", 15: "render.coarse",      # at model.call's end
    52: "moe.experts", 65: "moe.experts_bwd", 80: "train.backward",
    101: None}


def _launches(names=("cudaLaunchKernel",)):
    out = []
    for i, t in enumerate(sorted(LAUNCH_AT)):
        out.append((t * MS, (t + 0.01) * MS, names[i % len(names)]))
    return out


def _trace(host, units=2):
    return Trace(device_ops=[], spans=[(0.0, 0.2, "step")], host_ops=host,
                 window=(0.0, 0.2), units=units)


def test_self_time_leaves_out_nested_spans():
    sp = spans.program_spans(_trace(STEP))
    own = dict()
    for t, (s, e, n) in zip(spans.self_seconds(sp), sp):
        own.setdefault(n, []).append(round(t / MS, 9))
    assert own["render.rays"] == [37 - 34]        # coarse and fine inside
    assert own["render.coarse"] == [17 - 10]
    assert own["render.fine"] == [17]
    assert own["model.call"] == [10 - 5, 12 - 5]
    assert own["train.backward"] == [49 - (15 + 8)]
    assert own["train.step"] == [100 - (39 + 49 + 4 + 3)]
    assert own["moe.experts"] == [4, 5]


def test_readers_per_unit():
    tr = _trace(STEP + _launches(), units=2)
    assert spans.self_ms(tr, "render") == pytest.approx((3 + 7 + 17) / 2)
    assert spans.self_ms(tr, "model") == pytest.approx((5 + 7) / 2)
    assert spans.self_ms(tr, "moe") == pytest.approx((1 + 4 + 5 + 8) / 2)
    assert spans.whole_ms(tr, "remat.recompute") == pytest.approx(15 / 2)
    assert spans.whole_ms(tr, "train.adam") == pytest.approx(3 / 2)
    assert spans.whole_ms(tr, "train.finite") == pytest.approx(4 / 2)
    # units divide every reading
    one = _trace(STEP + _launches(), units=1)
    assert spans.self_ms(one, "moe") == pytest.approx(2 * spans.self_ms(
        tr, "moe"))
    assert spans.launches(one, "moe") == 2 * spans.launches(tr, "moe")


@pytest.mark.parametrize("names", [
    ("cudaLaunchKernel",),
    ("cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")])
def test_launches_go_to_the_innermost_span(names):
    tr = _trace(STEP + _launches(names), units=2)
    sp = spans.program_spans(tr)
    owners = [None if i is None else sp[i][2]
              for i in spans.launch_owners(tr, sp)]
    assert owners == [LAUNCH_AT[t] for t in sorted(LAUNCH_AT)]
    # the gate's, the two chain calls' and the chain backward's (on the
    # backward's thread, inside train.backward by time)
    assert spans.launches(tr, "moe") == 4 / 2
    assert spans.launches(tr, "render") == 2 / 2
    assert spans.launches(tr, "train.backward") == 1 / 2


def test_siblings_on_two_threads_do_not_nest():
    """A span that starts inside another and ends after it is no child."""
    host = _ops((0, 10, "snerf.train.backward"),
                (2, 6, "snerf.moe.experts_bwd"),
                (5, 9, "snerf.moe.combine_bwd"),
                (8, 14, "snerf.moe.dispatch_bwd"))
    sp = spans.program_spans(_trace(host))
    by_name = {n: round(t / MS, 9)
               for t, (_, _, n) in zip(spans.self_seconds(sp), sp)}
    assert by_name["train.backward"] == 10 - 7      # union of 2-6 and 5-9
    assert by_name["moe.experts_bwd"] == 4          # 5-9 is no child
    assert by_name["moe.dispatch_bwd"] == 6


def test_no_program_span_reads_none():
    bare = _trace(_launches() + [(0.0, 0.1, "aten::mm")])
    for read in (lambda t: spans.self_ms(t, "moe"),
                 lambda t: spans.whole_ms(t, "train.adam"),
                 lambda t: spans.launches(t, "moe")):
        assert read(bare) is None
        assert read(None) is None
        assert read(_trace(STEP, units=0)) is None


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name.replace('.', '_')}", tiny.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_metrics_of_a_tiny_traced_training_run(monkeypatch, tmp_path):
    """The tiny training cell, traced on the CPU: each new metric reads a
    finite value (no launches on the CPU: 0), and the recompute's spans
    are one a model call."""
    import run as portbench_run
    from harness import core
    monkeypatch.setattr(core, "CACHE", tmp_path / "cache")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    c = tiny.cell("train")
    c["traffic"]["trace_steps"] = 1
    out = portbench_run.run_cell(c, 2 ** 31 + 3, 0.2, True,
                                 torch.device("cpu"))
    run = out["run"]
    tr = run["trace"]
    names = [n for _, _, n in spans.program_spans(tr)]
    assert names.count("remat.recompute") * 2 == names.count("model.call")
    for name in ("render_host_ms_per_step.train",
                 "model_host_ms_per_step.train",
                 "moe_host_ms_per_step.train",
                 "recompute_host_ms_per_step.train",
                 "adam_host_ms_per_step.train",
                 "sync_wait_ms_per_step.train"):
        v = _metric(name)(run, c)
        assert v is not None and 0 < v < 1e5, (name, v)
    assert _metric("moe_launches_per_step.train")(run, c) == 0
    assert _metric("moe_launches_per_request.render")(run, c) is None
