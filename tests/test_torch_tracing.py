"""The port's spans (``switch_nerf_torch/utils/spans.py``) on the CPU, at
the tiny Building config (MoE trunk, background NeRF, remat on, 64-point
chunks: two chunks a foreground pass, one a background pass):

  * with no profiler recording, ``span`` is one shared null context and
    no ``record_function`` is entered, in a whole train and eval step;
  * under ``torch.profiler`` a train step records the span tree: each
    forward MoE span inside a model call, each model call inside a
    renderer pass or a recompute, each recompute and each backward span
    inside ``train.backward``; one recompute a model call, one forward
    model call a chunk;
  * an eval step records eval.step > render.rays > passes > model.call >
    moe.*;
  * the profiler changes no bit: losses, gradients, parameters and
    rendered colours equal with it on and off.
"""
import contextlib
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from switch_nerf_torch import remat
from switch_nerf_torch import trainer as ttrainer
from switch_nerf_torch.models import model_utils as tmu
from switch_nerf_torch.utils import spans
from tests.torch_port_helpers import ray_batch, tiny_building_hparams

SCENE = ttrainer.SceneInfo(np.zeros(3, np.float32), np.ones(3, np.float32))
RAYS = 32
# 32 rays x 4 samples in 64-point chunks: 2 coarse and 2 fine foreground
# calls, 1 coarse and 1 fine background call (half the samples)
CALLS = 2 + 2 + 1 + 1
FORWARD_MOE = ("moe.gate", "moe.route", "moe.dispatch", "moe.experts",
               "moe.combine")
BACKWARD = ("moe.experts_bwd", "moe.dispatch_bwd", "moe.combine_bwd",
            "model.embedding_bwd")
PASSES = ("render.bg", "render.coarse", "render.fine")


class _KeepGrads(ttrainer.TrainStep):
    def _apply(self, state, grads, applies):
        self.grads = [g.clone() for g in grads]
        return super()._apply(state, grads, applies)


def _hparams():
    h = tiny_building_hparams()
    h.moe_train_batch = True
    h.train_iterations = 100
    h.model_chunk_size = 64
    assert h.remat and h.use_moe and h.bg_nerf
    return h


def _run(h, models, traced):
    """One train step and one eval request from copies of `models`; the
    step's metrics, gradients, parameters and moments, the eval's results,
    and the spans of each (None untraced) as (start, end, name)."""
    model, bg = copy.deepcopy(models)
    state = ttrainer.create_train_state(h, model, bg, device="cpu", seed=3)
    cfg = ttrainer.render_config_from_hparams(h)
    step = _KeepGrads(h, cfg, SCENE, "cpu")
    evaluate = ttrainer.make_eval_step(model, bg, h, cfg, SCENE,
                                       device="cpu")
    batch = ray_batch(RAYS, seed=1)
    batch["rgbs"] = np.random.default_rng(2).uniform(
        size=(RAYS, 3)).astype(np.float32)
    remat.reset_stats()
    out = {}
    with (profile(activities=[ProfilerActivity.CPU]) if traced
          else contextlib.nullcontext()) as prof:
        state, metrics = step(state, batch)
    out["train_spans"] = _spans(prof)
    out["stats"] = dict(remat.STATS)
    with (profile(activities=[ProfilerActivity.CPU]) if traced
          else contextlib.nullcontext()) as prof:
        results = evaluate(ray_batch(RAYS, seed=4))
    out["eval_spans"] = _spans(prof)
    adam = [state.optimizer.state[p] for p in state.parameters()]
    out["numbers"] = {
        "metrics": {k: v.clone() for k, v in metrics.items()},
        "grads": step.grads,
        "params": [p.detach().clone() for p in state.parameters()],
        "exp_avg": [a["exp_avg"] for a in adam],
        "exp_avg_sq": [a["exp_avg_sq"] for a in adam],
        "results": results}
    return out


def _spans(prof):
    if prof is None:
        return None
    return [(e.time_range.start, e.time_range.end, e.name[len("snerf."):])
            for e in prof.events() if e.name.startswith("snerf.")]


@pytest.fixture(scope="module")
def runs():
    h = _hparams()
    models = (tmu.get_nerf(h, 8, device="cpu", seed=0),
              tmu.get_bg_nerf(h, 8, device="cpu", seed=1))
    with pytest.MonkeyPatch.context() as mp:
        def refuse(*args, **kwargs):
            raise AssertionError("record_function entered with no profiler")
        mp.setattr(torch.profiler, "record_function", refuse)
        off = _run(h, models, traced=False)
    return off, _run(h, models, traced=True)


def _inside(inner, outers):
    s, e, _ = inner
    return any(a <= s and e <= b for a, b, _ in outers)


def _named(spans_, *names):
    return [sp for sp in spans_ if sp[2] in names]


def test_no_profiler_no_record_function(runs, monkeypatch):
    """The untraced step and request above ran with record_function
    raising; a span is the one shared null context."""
    off, _ = runs
    assert off["train_spans"] is None and off["stats"]["calls"] == CALLS
    monkeypatch.setattr(torch.profiler, "record_function", None)
    assert spans.span("train.step") is spans.span("moe.gate", "7")
    with spans.span("render.rays") as inside:
        assert inside is None


def test_train_step_span_tree(runs):
    _, on = runs
    sp = on["train_spans"]
    (step,) = _named(sp, "train.step")
    assert all(_inside(s, [step]) for s in sp)
    calls = _named(sp, "model.call")
    recomputes = _named(sp, "remat.recompute")
    for s in _named(sp, *FORWARD_MOE):
        assert _inside(s, calls), s
    for s in calls:
        assert _inside(s, _named(sp, *PASSES) + recomputes), s
    for s in recomputes + _named(sp, *BACKWARD):
        assert _inside(s, _named(sp, "train.backward")), s
    for s in _named(sp, *PASSES):
        assert _inside(s, _named(sp, "render.rays")), s
    (forward,) = _named(sp, "train.forward")
    assert _inside(_named(sp, "render.rays")[0], [forward])
    # the finite vote and the update, after the backward, in the step
    names = [n for _, _, n in sorted(sp)]
    assert names.index("train.finite") < names.index("train.adam")
    assert "train.allreduce" not in names               # one process
    assert {n for n in names} >= set(FORWARD_MOE + BACKWARD + PASSES)


def test_recompute_and_call_counts(runs):
    _, on = runs
    sp, stats = on["train_spans"], on["stats"]
    recomputes = _named(sp, "remat.recompute")
    calls = _named(sp, "model.call")
    assert len(recomputes) == stats["recomputes"] == CALLS
    in_recompute = [c for c in calls if _inside(c, recomputes)]
    assert len(calls) - len(in_recompute) == stats["calls"] == CALLS
    assert len(in_recompute) == CALLS


def test_eval_span_tree(runs):
    _, on = runs
    sp = on["eval_spans"]
    (step,) = _named(sp, "eval.step")
    (rays,) = _named(sp, "render.rays")
    assert _inside(rays, [step])
    for s in _named(sp, *PASSES):
        assert _inside(s, [rays]), s
    calls = _named(sp, "model.call")
    assert len(calls) == CALLS
    for s in calls:
        assert _inside(s, _named(sp, *PASSES)), s
    moe = _named(sp, *FORWARD_MOE)
    assert moe and all(_inside(s, calls) for s in moe)
    assert not _named(sp, *BACKWARD, "remat.recompute", "train.step")


def test_profiler_changes_no_bit(runs):
    off, on = (r["numbers"] for r in runs)
    for key in ("metrics", "results"):
        assert off[key].keys() == on[key].keys()
        for k in off[key]:
            assert torch.equal(off[key][k], on[key][k]), (key, k)
    for key in ("grads", "params", "exp_avg", "exp_avg_sq"):
        assert len(off[key]) == len(on[key]) > 0
        for a, b in zip(off[key], on[key]):
            assert torch.equal(a, b), key

