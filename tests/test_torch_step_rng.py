"""Dropout masks and gate noise come from the training step's generator,
which the checkpoint carries: a resumed run draws what an uninterrupted
run draws, as in the JAX package (whose dropout and gate-noise keys split
from the checkpointed step key).

On the 24x16 synthetic scene at the tiny Building config with a dropout
layer after the MoE layer, gate noise 1.0 with the load-importance loss,
perturbation and sigma noise: a 4-step memory run, and a cold resume from
its step-2 checkpoint, are bit-equal (per-step metrics, parameters, Adam
moments, the generator's state); the masks and the noise really move the
step (a run without them takes other values); and the port draws no
mask from the model's init generator.
"""
import copy

import torch

from switch_nerf_torch import runner as trunner
from switch_nerf_torch.models.common import Dropout
from tests.test_torch_train_resume import (assert_records_equal, assert_same,
                                           noisy_hparams, recording,
                                           snapshot)
from tests.torch_port_helpers import make_mega_scene

STEPS, CKPT = 4, 2


def dropout_graph(h, rate=0.25):
    """The tiny Building graph with a dropout layer between the MoE layer
    and the dir tag."""
    g = copy.deepcopy(h.model)
    lay = g["layers"]
    lay["3"] = lay.pop("2")
    lay["2"] = lay.pop("1")
    lay["1"] = {"type": "dropout", "prob": rate, "act": "none"}
    g.update(layer_num_main=4, dir_tag=2, color_tag=3)
    return g


def test_resumed_run_draws_the_same_masks_and_noise(tmp_path, monkeypatch):
    scene = make_mega_scene(tmp_path / "scene")

    def run(name, rate=0.25, noise=1.0, **over):
        h = noisy_hparams(scene, tmp_path / name, "memory",
                          **{"train_iterations": STEPS,
                             "ckpt_interval": CKPT, **over})
        h.model = dropout_graph(h, rate)
        h.gate_noise = noise
        h.use_load_importance_loss = h.gate_noise > 0
        with monkeypatch.context() as m:
            recs = recording(m)
            runner = trunner.Runner(h, device="cpu")
            state = runner.train()
        return runner, state, recs

    ra, state, reca = run("a")
    assert any(isinstance(m, Dropout) for m in state.model.modules())
    sa = snapshot(state)
    _, state_b, recb = run("b", ckpt_path=str(ra.model_path / str(CKPT)))
    assert_same(snapshot(state_b), sa)
    assert_records_equal(recb, {k: v for k, v in reca.items()
                                if k[0] > CKPT})

    # without the masks and the noise the same run takes other values
    _, _, recc = run("c", rate=0.0, noise=-1.0)
    assert not torch.equal(recc[(1, 1)]["loss"], reca[(1, 1)]["loss"])


def test_dropout_draws_from_the_callers_generator():
    d = Dropout(0.5)
    x = torch.ones(256)
    g = torch.Generator().manual_seed(3)
    s = g.get_state()
    a = d(x, train=True, generator=g)
    g.set_state(s)
    b = d(x, train=True, generator=g)
    assert torch.equal(a, b)
    c = d(x, train=True, generator=g)
    assert not torch.equal(a, c)
    assert not hasattr(d, "generator")      # no init-time generator
