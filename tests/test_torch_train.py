"""The port's training step vs the JAX package's, on the CPU, at the tiny
Building config (moe_train_batch, background NeRF on, perturb 0, no sigma
noise), plus the optimizer schedule, the finite check and the random draws.

Weights come from the JAX package's create_train_state through the bridge;
parameters after each step come back through the reverse bridge.

Tolerances: fp32 (--no_amp) every metric and every parameter to 1e-4 after
each of 2 steps (padded drop sets make longer runs agree only
statistically). bf16 (--amp) one step: metrics to 2e-3 relative (bf16
rounds at other places in the two frameworks), parameters to 2 * lr (Adam's
first update moves each parameter by about +-lr, so a rounding that flips
the sign of a near-zero gradient moves it by up to 2 * lr).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from switch_nerf_tpu import trainer as jtrainer
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import bridge
from switch_nerf_torch import trainer as ttrainer
from switch_nerf_torch.models import model_utils as tmu
from switch_nerf_torch.ops import expert_kernel, fused_dispatch
from tests.torch_port_helpers import (jax_train_state, ray_batch,
                                      tiny_building_hparams, to_jax)

SCENE = (np.zeros(3, np.float32), np.ones(3, np.float32))


def train_hparams(amp=False, width=16):
    h = tiny_building_hparams(width=width)
    h.moe_train_batch = True
    h.amp = amp
    h.perturb = 0.0
    h.use_sigma_noise = False
    h.train_iterations = 100
    return h


def train_batch(n, seed):
    b = ray_batch(n, seed=seed)
    b["rgbs"] = np.random.default_rng(100 + seed).uniform(
        size=(n, 3)).astype(np.float32)
    return b


def port_state(h, np_params, device="cpu", seed=None):
    tm = tmu.get_nerf(h, 8, device=device)
    tbg = tmu.get_bg_nerf(h, 8, device=device)
    bridge.load_jax_state(tm, tbg, np_params)
    return ttrainer.create_train_state(h, tm, tbg, device=device, seed=seed)


def jax_setup(h):
    jm, jbg = jmu.get_nerf(h, 8), jmu.get_bg_nerf(h, 8)
    state = jax_train_state(jax.random.PRNGKey(0), h, jm, jbg)
    step = jax.jit(jtrainer.make_train_step(
        jm, jbg, h, jtrainer.render_config_from_hparams(h),
        jtrainer.SceneInfo(*map(jnp.asarray, SCENE))))
    return state, step


def port_step(h, device="cpu"):
    return ttrainer.make_train_step(h, ttrainer.render_config_from_hparams(h),
                                    ttrainer.SceneInfo(*SCENE), device=device)


@pytest.fixture(scope="module")
def fp32_setup():
    """The JAX fp32 train step, built once for the module."""
    h = train_hparams()
    state, step = jax_setup(h)
    return h, state, step


def _compare(jmet, tmet, jparams, tstate, mtol, ptol, ptol_rel=True):
    assert sorted(jmet) == sorted(tmet)
    for k in jmet:
        a, b = float(tmet[k]), float(jmet[k])
        assert abs(a - b) <= mtol * max(1.0, abs(b)), (k, a, b)
    ref = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jparams))
    out = jax.tree_util.tree_leaves(
        bridge.export_jax_state(tstate.model, tstate.bg_model))
    assert len(ref) == len(out)
    for (path, b), a in zip(ref, out):
        scale = max(1.0, float(np.abs(b).max())) if ptol_rel else 1.0
        err = float(np.abs(a - b).max())
        assert err <= ptol * scale, (jax.tree_util.keystr(path), err)


# 600 rays x 4 samples: a full 2048-point chunk and a remainder per pass
def test_train_steps_match_jax(fp32_setup):
    h, jstate, jstep = fp32_setup
    tstate = port_state(h, jax.tree_util.tree_map(np.asarray, jstate.params))
    tstep = port_step(h)
    for i in range(2):
        batch = train_batch(600, seed=i)
        jstate, jmet = jstep(jstate, to_jax(batch))
        tstate, tmet = tstep(tstate, batch)
        assert float(tmet["finite"]) == 1.0
        _compare(jmet, tmet, jstate.params, tstate, 1e-4, 1e-4)
    assert tstate.step == int(jstate.step) == 2
    assert tstate.opt_step == 2


def test_amp_train_step_matches_jax():
    h = train_hparams(amp=True)
    jstate, jstep = jax_setup(h)
    tstate = port_state(h, jax.tree_util.tree_map(np.asarray, jstate.params))
    batch = train_batch(300, seed=3)
    jstate, jmet = jstep(jstate, to_jax(batch))
    tstate, tmet = port_step(h)(tstate, batch)
    _compare(jmet, tmet, jstate.params, tstate, 2e-3, 2 * h.lr,
             ptol_rel=False)


def _snapshot(state):
    return (copy.deepcopy([p.detach().clone() for p in state.parameters()]),
            copy.deepcopy(state.optimizer.state_dict()), state.opt_step,
            state.step)


def _same(a, b):
    pa, oa, *ca = a
    pb, ob, *cb = b
    assert ca == cb
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    sa, sb = oa["state"], ob["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for name in sa[k]:
            assert torch.equal(sa[k][name], sb[k][name]), (k, name)


@pytest.mark.parametrize("acc", [1, 2])
def test_nonfinite_batch_skips_the_update(fp32_setup, acc):
    """A NaN batch leaves parameters, optimizer state, schedule and step
    alone and (acc 2) discards the accumulation window, as the JAX step's
    lax.cond and _reset_multisteps; the next finite window then applies."""
    h = copy.copy(fp32_setup[0])
    h.accumulation_steps = acc
    np_params = jax.tree_util.tree_map(np.asarray, fp32_setup[1].params)
    state = port_state(h, np_params)
    step = port_step(h)
    good = train_batch(64, seed=4)
    bad = dict(good, rays=np.full_like(good["rays"], np.nan))

    state, met = step(state, good)              # acc 2: half a window
    assert float(met["finite"]) == 1.0
    assert state.mini_step == (1 if acc == 2 else 0)
    before = _snapshot(state)
    state, met = step(state, bad)
    assert float(met["finite"]) == 0.0
    _same(before, _snapshot(state))
    assert state.mini_step == 0
    if acc == 2:
        assert not any(a.any() for a in state.acc_grads)
        state, _ = step(state, good)            # a fresh window: no update
        assert state.opt_step == 0 and state.mini_step == 1
        state, _ = step(state, good)
    assert state.opt_step == 1


@pytest.mark.parametrize("acc", [1, 2])
def test_lr_schedule_matches_optax(acc):
    """lr_schedule vs the JAX package's optax.exponential_decay, and the
    rate Adam actually applied at each optimizer step (train_iterations 10
    makes the decay visible)."""
    h = train_hparams()
    h.train_iterations = 10
    h.accumulation_steps = acc
    gamma = h.lr_decay_factor ** (1.0 / h.train_iterations)
    ref = optax.exponential_decay(init_value=h.lr * gamma ** (acc - 1),
                                  transition_steps=1, decay_rate=gamma ** acc)
    sched = ttrainer.lr_schedule(h)
    for t in range(6):
        np.testing.assert_allclose(sched(t), float(ref(t)), rtol=1e-6)

    model = tmu.get_nerf(h, 8, device="cpu", seed=0)
    state = ttrainer.create_train_state(h, model, None, device="cpu")
    step = port_step(h)
    seen = []
    for i in range(3 * acc):
        state, _ = step(state, train_batch(32, seed=i))
        seen.append(state.optimizer.param_groups[0]["lr"])
    np.testing.assert_allclose(seen[acc - 1::acc], [float(ref(t))
                                                    for t in range(3)],
                               rtol=1e-6)
    np.testing.assert_allclose(
        ttrainer.lr_schedule(type(h)(**dict(vars(h),
                                            no_optimizer_schedulers=True)))(5),
        h.lr)


def test_train_draws_follow_the_seed():
    """Perturbation, random fine samples, sigma noise and the random
    background colour all come from the state's generator: the same seed
    gives the same step, another seed another one."""
    h = train_hparams()
    h.perturb = 1.0
    h.use_sigma_noise = True
    h.use_random_background_color = True
    batch = train_batch(64, seed=5)

    def metrics(seed):
        model = tmu.get_nerf(h, 8, device="cpu", seed=0)
        bg = tmu.get_bg_nerf(h, 8, device="cpu", seed=1)
        state = ttrainer.create_train_state(h, model, bg, device="cpu",
                                            seed=seed)
        return port_step(h).loss_and_grads(state, batch)[0]

    a, b, c = metrics(7), metrics(7), metrics(8)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["all_loss"], c["all_loss"])


def test_fused_train_grads_match_unfused(monkeypatch):
    """SWITCH_NERF_FUSED_DISPATCH=1 (FusedDispatchFn: K3/K4's plain
    versions here) gives the unfused step's loss and gradients to 1e-5."""
    h = train_hparams(width=64)                  # a width the kernel takes
    model = tmu.get_nerf(h, 8, device="cpu", seed=0)
    bg = tmu.get_bg_nerf(h, 8, device="cpu", seed=1)
    state = ttrainer.create_train_state(h, model, bg, device="cpu")
    step = port_step(h)
    batch = train_batch(300, seed=6)
    monkeypatch.setenv("SWITCH_NERF_FUSED_DISPATCH", "0")
    ref_met, ref = step.loss_and_grads(state, batch)
    monkeypatch.setenv("SWITCH_NERF_FUSED_DISPATCH", "1")
    calls = []
    real = fused_dispatch.fused_dispatch_chain_bwd_plain
    monkeypatch.setattr(fused_dispatch, "fused_dispatch_chain_bwd_plain",
                        lambda *a: calls.append(1) or real(*a))
    met, grads = step.loss_and_grads(state, batch)
    assert calls, "the fused backward did not run"
    np.testing.assert_allclose(float(met["all_loss"]),
                               float(ref_met["all_loss"]), rtol=1e-6)
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_expert_weights_get_gradients_through_the_chain(monkeypatch):
    """Every expert weight and bias gets a non-zero gradient, through
    ExpertChainFn's backward (the plain K2 on the CPU)."""
    h = train_hparams(width=64)
    model = tmu.get_nerf(h, 8, device="cpu", seed=0)
    state = ttrainer.create_train_state(h, model, None, device="cpu")
    calls = []
    real = expert_kernel.expert_mlp_chain_bwd_plain
    monkeypatch.setattr(expert_kernel, "expert_mlp_chain_bwd_plain",
                        lambda *a: calls.append(1) or real(*a))
    _, grads = port_step(h).loss_and_grads(state, train_batch(64, seed=7))
    assert calls
    for (name, _), g in zip(model.named_parameters(), grads):
        if ".experts." in name:
            assert g.abs().max() > 0, name


def test_bridge_export_matches_the_jax_tree(fp32_setup):
    """export_jax_state gives the JAX tree's structure, every leaf, and the
    loaded values back."""
    h, jstate, _ = fp32_setup
    np_params = jax.tree_util.tree_map(np.asarray, jstate.params)
    state = port_state(h, np_params)
    out = bridge.export_jax_state(state.model, state.bg_model)
    assert (jax.tree_util.tree_structure(out)
            == jax.tree_util.tree_structure(np_params))
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)


def test_train_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    h = train_hparams()
    model = tmu.get_nerf(h, 8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.create_train_state(h, model, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.make_train_step(h, ttrainer.render_config_from_hparams(h),
                                 ttrainer.SceneInfo())
