"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run of a tiny cell on the CPU (float32, where a sound run reads gaps at
rounding) with the cell's real limits, one fault planted in the program:

- training: a step that returns its state unchanged; half of the batch
  left out, the mean taken over the rest; the rendered colours of a tenth
  of the rays altered where the renderer produces them;
- rendering: half of each request's rays left out (the rest answered
  twice); one request's answers altered; every eighth ray's colour off by
  a little more than a wrong ray's tolerance.

The cells run on one card, so no exchange between cards is left out.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import json

import pytest
import torch

import tiny  # noqa: F401  (puts portbench/ on the path)
from harness import core
import run as portbench_run


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(core, "CACHE", tmp_path / "cache")


def limits(cell_name):
    return json.loads((tiny.HERE / "limits" / f"{cell_name}.json")
                      .read_text())


def _run(kind, cell_name):
    c = tiny.cell(kind, limits=limits(cell_name))
    return portbench_run.run_cell(c, 2 ** 31 + 11, 0.5, False,
                                  torch.device("cpu"))


def _unchanged(monkeypatch):
    from switch_nerf_torch import trainer

    def apply(self, state, grads, applies):
        state.step += 1
        state.opt_step += 1
    monkeypatch.setattr(trainer.TrainStep, "_apply", apply)


def _half_batch(monkeypatch):
    from switch_nerf_torch import trainer
    orig = trainer.TrainStep.loss_and_grads

    def half(self, state, batch):
        n = batch["rays"].shape[0] // 2
        return orig(self, state, {k: v[:n] for k, v in batch.items()})
    monkeypatch.setattr(trainer.TrainStep, "loss_and_grads", half)


def _colours_altered(monkeypatch):
    from switch_nerf_torch import trainer
    orig = trainer.compute_losses

    def altered(results, rgbs, hparams, *a, **k):
        results = dict(results)
        rgb = results["rgb_fine"]
        n = max(rgb.shape[0] // 10, 1)
        results["rgb_fine"] = torch.cat([rgb[:n] + 0.05, rgb[n:]])
        return orig(results, rgbs, hparams, *a, **k)
    monkeypatch.setattr(trainer, "compute_losses", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _colours_altered])
def test_training_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run("train", "building-train")
    assert not out["correct"], out["checks"]


def _render_half(monkeypatch):
    from switch_nerf_torch import trainer
    orig = trainer.make_eval_step

    def make(*a, **k):
        step = orig(*a, **k)

        def half(batch):
            n = batch["rays"].shape[0] // 2
            b = {k: torch.cat([v[:n], v[:n]]) for k, v in batch.items()}
            return step(b)
        return half
    monkeypatch.setattr(trainer, "make_eval_step", make)


def _render_altered(monkeypatch):
    from switch_nerf_torch import trainer
    orig = trainer.make_eval_step

    def make(*a, **k):
        step = orig(*a, **k)
        calls = {"n": 0}

        def altered(batch):
            out = step(batch)
            calls["n"] += 1
            if calls["n"] == 2:                 # the window's first request
                out = dict(out, rgb_fine=out["rgb_fine"] + 0.02)
            return out
        return altered
    monkeypatch.setattr(trainer, "make_eval_step", make)


def _render_minority(monkeypatch):
    from switch_nerf_torch import trainer
    orig = trainer.make_eval_step

    def make(*a, **k):
        step = orig(*a, **k)

        def altered(batch):
            out = step(batch)
            rgb = out["rgb_fine"].clone()
            rgb[::8] += 0.012                   # every eighth ray, a little
            return dict(out, rgb_fine=rgb)
        return altered
    monkeypatch.setattr(trainer, "make_eval_step", make)


@pytest.mark.parametrize("fault", [_render_half, _render_altered,
                                   _render_minority])
def test_render_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run("render", "building-render")
    assert not out["correct"], out["checks"]
