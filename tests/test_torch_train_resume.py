"""The port's training runner against itself, and its train CLI, on the
CPU (tests/test_torch_train_runner.py holds it against the JAX package's).

On the 24x16 synthetic scene at the tiny Building config, with perturb and
sigma noise on: a run resumed from an interval checkpoint, from a SIGTERM
checkpoint, or after a skipped non-finite step is bit-equal to the
uninterrupted run (per-step metrics, parameters, Adam moments, the
generator's state). ``train.main(h, device="cpu")`` writes chunks with
--generate_chunk, a trace with --profile_trace_step, and refuses Block-NeRF
data.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

from switch_nerf_torch import runner as trunner
from switch_nerf_torch import train as ttrain
from switch_nerf_torch.datasets.memory_dataset import MemoryDataset
from tests.torch_port_helpers import (block_runner_hparams, make_block_test_scene,
                                      make_mega_scene)
from tests.torch_port_helpers import mega_train_hparams as train_hparams


@pytest.fixture(scope="module")
def mega_dataset(tmp_path_factory):
    return make_mega_scene(tmp_path_factory.mktemp("mega"))


def recording(monkeypatch, kill_at=None):
    """Wrap the runner's train step: per-step metrics keyed by (state.step
    after the step, finite flag); SIGTERM raised from inside step
    `kill_at`."""
    recs = {}
    real = trunner.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def run(state, batch):
            state, m = step(state, batch)
            key = (state.step, int(m["finite"]))
            recs[key] = {k2: v.clone() for k2, v in m.items()}
            if kill_at is not None and state.step == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, m
        return run
    monkeypatch.setattr(trunner, "make_train_step", make)
    return recs


def snapshot(state):
    params = [p.detach().clone() for p in state.parameters()]
    moments = [{k: v.clone() for k, v in state.optimizer.state[p].items()}
               for p in state.parameters()]
    return params, moments, state.generator.get_state(), state.step


def assert_same(a, b):
    (pa, ma, ga, sa), (pb, mb, gb, sb) = a, b
    assert sa == sb
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert torch.equal(ga, gb)


def assert_records_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        for k in want[key]:
            assert torch.equal(got[key][k], want[key][k]), (key, k)


def noisy_hparams(root, exp, dataset_type, chunks=None, **over):
    h = train_hparams(root, exp, dataset_type, chunks)
    h.perturb = 1.0
    h.use_sigma_noise = True
    for k, v in over.items():
        setattr(h, k, v)
    return h


def test_exact_resume_interval_and_sigterm(mega_dataset, tmp_path,
                                           monkeypatch):
    """A 12-step filesystem run (two chunk boundaries); a cold resume from
    its step-8 checkpoint; a run stopped by SIGTERM from inside step 5,
    which saves, returns and restores the previous handler, then resumes:
    both bit-equal to the uninterrupted run."""
    n, kill = 12, 5
    chunks = tmp_path / "chunks"

    def run(name, kill_at=None, **over):
        h = noisy_hparams(mega_dataset, tmp_path / name, "filesystem",
                          chunks, **{"train_iterations": n,
                                     "ckpt_interval": 4, **over})
        with monkeypatch.context() as m:
            recs = recording(m, kill_at)
            runner = trunner.Runner(h, device="cpu")
            state = runner.train()
        return runner, snapshot(state), recs

    ra, sa, reca = run("a")
    assert sa[3] == n and sorted(reca) == [(s, 1) for s in range(1, n + 1)]
    assert sorted(p.name for p in ra.model_path.iterdir()) == \
        ["12", "4", "8"]
    _, sb, recb = run("b", ckpt_path=str(ra.model_path / "8"))
    assert_same(sb, sa)
    assert_records_equal(recb, {k: v for k, v in reca.items() if k[0] > 8})

    prev = signal.getsignal(signal.SIGTERM)
    rc, sc, recc = run("c", kill_at=kill, ckpt_interval=10 ** 9)
    assert signal.getsignal(signal.SIGTERM) is prev
    assert sc[3] == kill
    assert sorted(p.name for p in rc.model_path.iterdir()) == [str(kill)]
    assert_records_equal(recc, {k: v for k, v in reca.items()
                                if k[0] <= kill})
    _, sd, recd = run("d", ckpt_path=str(rc.model_path / str(kill)))
    assert_same(sd, sa)
    assert_records_equal(recd, {k: v for k, v in reca.items()
                                if k[0] > kill})


def test_exact_resume_after_skipped_step(mega_dataset, tmp_path,
                                         monkeypatch):
    """Memory dataset, a NaN batch at counter 3: the step is skipped (the
    state's step lags the batch counter), the counter-5 checkpoint is step
    dir 4 with host_iteration 5, and a resume from it is bit-equal."""
    n, nan_at, ckpt = 10, 3, 5
    real = MemoryDataset.get_batch

    def poisoned(self, global_batch, batch_size):
        b = real(self, global_batch, batch_size)
        if global_batch == nan_at:
            b = dict(b, rgbs=np.full_like(b["rgbs"], np.nan))
        return b
    monkeypatch.setattr(MemoryDataset, "get_batch", poisoned)

    def run(name, **over):
        h = noisy_hparams(mega_dataset, tmp_path / name, "memory",
                          train_iterations=n, **over)
        with monkeypatch.context() as m:
            recs = recording(m)
            runner = trunner.Runner(h, device="cpu")
            state = runner.train()
        return runner, snapshot(state), recs

    ra, sa, reca = run("a", ckpt_interval=ckpt)
    assert sa[3] == n - 1 and (nan_at, 0) in reca
    extra = json.loads((ra.model_path / str(ckpt - 1) / "extra.json"
                        ).read_text())
    assert (extra["iteration"], extra["host_iteration"]) == (ckpt - 1, ckpt)
    _, sb, recb = run("b", ckpt_interval=10 ** 9,
                      ckpt_path=str(ra.model_path / str(ckpt - 1)))
    assert_same(sb, sa)
    assert_records_equal(recb, {k: v for k, v in reca.items()
                                if k[0] >= ckpt})


@pytest.mark.parametrize("case", ["generate_chunk", "profile", "block_nerf"])
def test_train_cli(mega_dataset, tmp_path, case):
    """train.main on the CPU: --generate_chunk writes the chunks and
    returns; --profile_trace_step writes a Chrome trace under profile/;
    Block-NeRF data trains from its tfrecords (tests/
    test_torch_block_runner.py holds that run against the JAX package's)."""
    h = train_hparams(mega_dataset, tmp_path / "exp", "filesystem",
                      tmp_path / "chunks")
    exp = tmp_path / "exp" / "0"
    if case == "generate_chunk":
        h.generate_chunk = True
        assert ttrain.main(h, device="cpu") is None
        assert (tmp_path / "chunks" / "manifest.json").exists()
        assert not any((exp / "models").iterdir())
    elif case == "profile":
        h.profile_trace_step = 1
        h.train_iterations = 4
        h.ckpt_interval = 10 ** 9
        assert ttrain.main(h, device="cpu").step == 4
        assert (exp / "profile" / "train_steps_1.json").stat().st_size > 0
        assert sorted(p.name for p in (exp / "models").iterdir()) == ["4"]
        assert "iter 4 " in (exp / "log.txt").read_text()
    else:
        scene = make_block_test_scene(tmp_path / "block")
        hb = block_runner_hparams(scene, tmp_path / "bexp",
                                  tmp_path / "bchunks")
        assert ttrain.main(hb, device="cpu").step == 3
        assert sorted(p.name for p in
                      (tmp_path / "bexp" / "0" / "models").iterdir()) == \
            ["2", "3"]
