"""Rematerialisation (--remat, ``switch_nerf_torch/remat.py``) in the port,
on the CPU: against the port without it, bit for bit, and against the JAX
package, whose ``jax.checkpoint`` with its save-only-these-names policy it
ports.

  * the JAX ``test_remat_save_names_invariant`` toy through the port's
    ``run_model_chunked``: the default save set, SWITCH_NERF_REMAT_SAVE=
    -pe_out and remat off give bit-equal gradients, within 1e-6 of the
    largest of JAX's ``jax.grad`` with remat on (the two frameworks' sin
    and matmul round apart at float32's last bits);
  * two port train steps with --remat and --no_remat, at the tiny
    Building config of tests/test_torch_train.py (perturbation on,
    1,024-point chunks: 300 rays make a chunk and a remainder a pass) and
    in 7 cases, are bit-equal in every metric, every
    parameter and the step generator's state; one step with remat is
    within 1e-4 of JAX's ``make_train_step`` (remat on, its default).
    For that step both packages draw the same arrays: a normal draw or a
    dropout mask of a given shape is made by numpy from that shape (a
    stand-in for ``jax.random.normal`` / ``bernoulli`` on the JAX side,
    for ``torch.randn`` and ``Dropout.keep_mask`` on the port's), with no
    perturbation. The fused case is held against JAX's unfused step (the
    same function and config as the sigma-noise case, whose JAX step it
    shares; JAX's fused branch runs Pallas in interpret mode);
  * the counts: the routing runs once a model call and MoE layer, each
    call is recomputed once, the kept bytes are the named set (moe_plan,
    moe_dispatched, pe_out) plus the calls' inputs, and less than what
    autograd holds inside the calls without remat
    (``torch.autograd.graph.saved_tensors_hooks``);
  * a 2-rank gloo job (tests/torch_parallel_worker.py): a model chunk that
    spans the ranks (shared-chunk routing) and expert parallelism
    (--expert_parallel --mesh_shape 1 2), each trained one step with
    remat on and off, bit-equal on each rank (metrics, parameters, the
    generator).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu import trainer as jtrainer
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_tpu.ops.encoding import freq_encode as jfreq_encode
from switch_nerf_tpu.render import rendering as jrendering
from switch_nerf_torch import bridge, remat
from switch_nerf_torch import trainer as ttrainer
from switch_nerf_torch.models import model_utils as tmu
from switch_nerf_torch.models.common import Dropout
from switch_nerf_torch.ops import encoding, routing
from switch_nerf_torch.ops.encoding import freq_encode
from switch_nerf_torch.render import rendering
from tests.test_torch_expert_parallel import expert_parallel
from tests.test_torch_parallel import noisy, published
from tests.test_torch_step_rng import dropout_graph
from tests.test_torch_train import SCENE, _compare, train_batch, \
    train_hparams
from tests.torch_port_helpers import (Ranks, jax_train_state, make_mega_scene,
                                      mega_train_hparams, tiny_bungee_hparams,
                                      to_jax)


def test_remat_save_names_invariant(monkeypatch):
    pts = np.random.RandomState(5).randn(64, 3).astype(np.float32)
    w = np.random.RandomState(6).randn(27, 4).astype(np.float32)

    def port_grad(env, remat_on):
        monkeypatch.setenv("SWITCH_NERF_REMAT_SAVE", env)
        tw = torch.from_numpy(w).requires_grad_()

        def fn(p, sigma_noise, train, generator):
            return (torch.tanh(freq_encode(p, 4) @ tw),
                    p.new_zeros((0,)))
        cfg = rendering.RenderConfig(model_chunk_size=16,
                                     remat_chunks=remat_on)
        remat.reset_stats()
        out, _ = rendering.run_model_chunked(
            fn, torch.from_numpy(pts), cfg, rendering._Pass(train=True))
        (g,) = torch.autograd.grad(torch.sum(out ** 2), tw)
        return g.numpy(), dict(remat.STATS)

    grads, stats = {}, {}
    for name, env, on in [("default", "", True), ("no_pe", "-pe_out", True),
                          ("no_remat", "", False)]:
        grads[name], stats[name] = port_grad(env, on)
    np.testing.assert_array_equal(grads["default"], grads["no_pe"])
    np.testing.assert_array_equal(grads["default"], grads["no_remat"])
    assert stats["default"]["calls"] == stats["default"]["recomputes"] == 4
    assert stats["default"]["kept_bytes"] == {"pe_out": 64 * 27 * 4}
    assert stats["no_pe"]["kept_bytes"] == {}
    assert stats["no_remat"]["calls"] == 0

    monkeypatch.delenv("SWITCH_NERF_REMAT_SAVE")

    def jloss(jw):
        def fn(p, sigma_noise, rng, train):
            return (jnp.tanh(jfreq_encode(p, 4) @ jw),
                    jnp.zeros((0,), jnp.float32))
        out, _ = jrendering.run_model_chunked(
            fn, jnp.asarray(pts), jrendering.RenderConfig(
                model_chunk_size=16, remat_chunks=True),
            jax.random.PRNGKey(0), True)
        return jnp.sum(out ** 2)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(w)))
    err = np.abs(grads["default"] - want).max()
    assert err <= 1e-6 * np.abs(want).max(), err


def _building(h):
    h.use_sigma_noise = True
    return h


def _gate_noise_dropout(h):
    h.model = dropout_graph(h)
    h.gate_noise = 1.0
    h.use_load_importance_loss = h.compute_balance_loss = True
    return h


def _top2(h):
    h.model["layers"]["0"]["k"] = 2
    return h


def _nodrop(h):
    h.moe_train_batch = False
    return h


def _cascade(h):
    h.use_cascade = True
    return h


# case: (its change to the config, trunk width, SWITCH_NERF_FUSED_DISPATCH);
# sigma_noise and fused take one config (64: a width the fused kernel
# takes), so they share a JAX reference step (``jax_refs``)
CASES = {
    "sigma_noise": (_building, 64, None),
    "gate_noise_dropout": (_gate_noise_dropout, 16, None),
    "top2": (_top2, 16, None),
    "nodrop": (_nodrop, 16, None),
    "fused": (_building, 64, "1"),
    "cascade": (_cascade, 16, None),
    "mip": (None, 0, None),
}


def case_hparams(case, tmp_path):
    make, width, _ = CASES[case]
    if make is None:
        h = tiny_bungee_hparams(tmp_path, tmp_path / "exp", width=16)
        h.perturb = 1.0
        h.train_iterations = 100
        return h
    h = make(train_hparams(width=width))
    h.perturb = 1.0
    h.model_chunk_size = 1024        # 300 rays: a chunk and a remainder
    return h


def mip_batch(n, seed):
    """Bungee-like rays (tests/test_torch_mip.py's) with colours."""
    from tests.test_torch_mip import _rays
    rays, radii = _rays(n, seed)
    rgbs = np.random.default_rng(50 + seed).uniform(size=(n, 3))
    return {"rays": rays, "radii": radii, "rgbs": rgbs.astype(np.float32)}


def _port(h, np_params, mip, remat_on, seed=5):
    h = copy.copy(h)
    h.remat = remat_on
    tm = tmu.get_nerf(h, 8, device="cpu")
    tbg = None if mip else tmu.get_bg_nerf(h, 8, device="cpu")
    bridge.load_jax_state(tm, tbg, np_params)
    state = ttrainer.create_train_state(h, tm, tbg, device="cpu", seed=seed)
    step = ttrainer.make_train_step(
        h, ttrainer.render_config_from_hparams(h), ttrainer.SceneInfo(*SCENE),
        mip=mip, device="cpu")
    return state, step


def _draw(shape, kind):
    """The array both packages draw for `shape`: N(0, 1), or U[0, 1)."""
    rng = np.random.default_rng([len(shape), *shape, kind])
    if kind == 0:
        return rng.normal(size=shape).astype(np.float32)
    return rng.uniform(size=shape).astype(np.float32)


def _same_draws(monkeypatch):
    """Shape-keyed normal draws and dropout masks in both packages."""
    monkeypatch.setattr(
        jax.random, "normal", lambda key, shape, dtype=jnp.float32:
        jnp.asarray(_draw(tuple(shape), 0), dtype))
    monkeypatch.setattr(
        jax.random, "bernoulli", lambda key, p, shape:
        jnp.asarray(_draw(tuple(shape), 1) < p))
    monkeypatch.setattr(
        torch, "randn", lambda shape, generator=None, dtype=None,
        device=None: torch.from_numpy(_draw(tuple(shape), 0)))
    monkeypatch.setattr(
        Dropout, "keep_mask", lambda self, x, generator=None:
        torch.from_numpy(_draw(tuple(x.shape), 1) < 1.0 - self.rate))


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's step-0 state and its one step with remat, by the config."""
    return {}


def jax_reference(h, mip, refs, monkeypatch):
    """(JAX's step-0 state, its numpy parameters, and the state and
    metrics after one step of JAX's make_train_step on the comparison
    batch, with the shape-keyed draws and no perturbation), made once for
    each config."""
    key = (repr(sorted(vars(h).items())), mip)
    if key not in refs:
        jm = jmu.get_nerf(h, 8)
        jbg = None if mip else jmu.get_bg_nerf(h, 8)
        state0 = jax_train_state(jax.random.PRNGKey(0), h, jm, jbg)
        h0 = copy.copy(h)
        h0.perturb = 0.0
        with monkeypatch.context() as m:
            _same_draws(m)
            jstep = jax.jit(jtrainer.make_train_step(
                jm, jbg, h0, jtrainer.render_config_from_hparams(h0),
                jtrainer.SceneInfo(*map(jnp.asarray, SCENE)), mip=mip))
            state1, met = jstep(state0, to_jax(compare_batch(mip)))
        refs[key] = (state0, jax.tree_util.tree_map(np.asarray,
                                                    state0.params),
                     state1, met)
    return refs[key]


def compare_batch(mip):
    return mip_batch(32, 7) if mip else train_batch(256, 7)


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_bit_equal_with_and_without_remat(case, tmp_path,
                                                      jax_refs, monkeypatch):
    h = case_hparams(case, tmp_path)
    mip = case == "mip"
    _, np_params, jstate, jmet = jax_reference(h, mip, jax_refs, monkeypatch)
    if CASES[case][2]:
        monkeypatch.setenv("SWITCH_NERF_FUSED_DISPATCH", CASES[case][2])
    batches = ([mip_batch(64, i) for i in range(2)] if mip
               else [train_batch(300, i) for i in range(2)])

    runs = {}
    for on in (True, False):
        state, step = _port(h, np_params, mip, on)
        mets = [step(state, b)[1] for b in batches]
        runs[on] = (mets, [p.detach().clone() for p in state.parameters()],
                    state.generator.get_state())
    for a, b in zip(runs[True][0], runs[False][0]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)
    assert torch.equal(runs[True][2], runs[False][2])

    # one step with remat against JAX's (remat on), the same draws
    h0 = copy.copy(h)
    h0.perturb = 0.0
    _same_draws(monkeypatch)
    remat.reset_stats()
    state, step = _port(h0, np_params, mip, True)
    state, tmet = step(state, compare_batch(mip))
    assert remat.STATS["recomputes"] == remat.STATS["calls"] > 0
    _compare(jmet, tmet, jstate.params, state, 1e-4, 1e-4)


def test_remat_routes_once_and_keeps_the_named_set(monkeypatch):
    h = train_hparams()
    h.perturb = 1.0
    h.use_sigma_noise = True
    batch = train_batch(600, 0)
    routes, encodings = [], []
    real_route, real_encode = routing._route, encoding._freq_encode
    monkeypatch.setattr(routing, "_route", lambda gates, *a: routes.append(
        (gates.shape[0], a[0])) or real_route(gates, *a))

    def encode(*a):
        out = real_encode(*a)
        encodings.append(out.numel() * out.element_size())
        return out
    monkeypatch.setattr(encoding, "_freq_encode", encode)

    def run(on):
        routes.clear()
        encodings.clear()
        remat.reset_stats()
        h1 = copy.copy(h)
        h1.remat = on
        tm = tmu.get_nerf(h1, 8, device="cpu", seed=0)
        tbg = tmu.get_bg_nerf(h1, 8, device="cpu", seed=1)
        state = ttrainer.create_train_state(h1, tm, tbg, device="cpu",
                                            seed=3)
        step = ttrainer.make_train_step(
            h1, ttrainer.render_config_from_hparams(h1),
            ttrainer.SceneInfo(*SCENE), device="cpu")
        held = []

        def pack(t):
            held.append(t.numel() * t.element_size())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            step.loss_and_grads(state, batch)
        return (list(routes), sum(encodings), sum(held), dict(remat.STATS),
                state.generator.get_state())

    r_on, enc_on, held_on, stats, gen_on = run(True)
    r_off, enc_off, held_off, _, gen_off = run(False)
    # the routing runs once a model call and MoE layer, as without remat
    assert r_on == r_off and len(r_on) == 4
    # fg: 2 passes of 2,400 points in a 2,048 chunk and the remainder; bg:
    # 2 passes of 1,200 (2 samples a ray)
    assert stats["calls"] == stats["recomputes"] == 6
    assert torch.equal(gen_on, gen_off)
    # the encodings are made once too, and kept
    assert enc_on == enc_off == stats["kept_bytes"]["pe_out"]
    kept = stats["kept_bytes"]
    assert sorted(kept) == ["moe_dispatched", "moe_plan", "pe_out"]
    m = h.model["layers"]["0"]["out_ch"]
    e = h.moe_expert_num
    caps = [routing.compute_capacity(s, e, k, h.moe_capacity_factor)
            for s, k in r_on]
    assert kept["moe_dispatched"] == sum(e * c * m * 4 for c in caps)
    # every call's points (fg 7 columns, bg 8) and sigma noise
    assert stats["input_bytes"] == 4 * (7 + 1) * 2 * 2400 \
        + 4 * (8 + 1) * 2 * 1200
    # what autograd holds outside the calls is the same either way; inside
    # them remat holds the kept set and the inputs, far less
    inside_on = sum(kept.values()) + stats["input_bytes"]
    assert held_on + inside_on < held_off
    print(f"bytes held: {held_off} without remat, {held_on} + "
          f"{inside_on} kept with it")


@pytest.fixture(scope="module", autouse=True)
def two_ranks(tmp_path_factory):
    """The 2-rank job, started before the module's first test so that it
    runs beside the JAX compiles."""
    tmp = tmp_path_factory.mktemp("remat_ranks")
    scene = make_mega_scene(tmp / "scene")
    scenarios = []
    for layout in ("shared", "ep"):
        for on in (True, False):
            name = f"{layout}_{'on' if on else 'off'}"
            h = noisy(published(mega_train_hparams(scene, tmp / name,
                                                   "memory")))
            h.train_iterations = 1
            h.remat = on
            if layout == "ep":
                h = expert_parallel(h, 1, 2)
            scenarios.append({"name": name, "kind": "train", "h": h})
    return Ranks(tmp / "job.pkl", scenarios)


@pytest.mark.parametrize("layout", ["shared", "ep"])
def test_two_ranks_bit_equal_with_and_without_remat(layout, two_ranks):
    on, off = (two_ranks.get(f"{layout}_{s}") for s in ("on", "off"))
    for a, b in zip(on, off):
        assert a["step"] == b["step"] == 1
        assert a["metrics"] == b["metrics"]
        for x, y in zip(a["params"], b["params"]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a["generator"], b["generator"])
    # the ranks drew their own noise, and trained the same model
    assert not np.array_equal(on[0]["generator"], on[1]["generator"])
    assert on[0]["metrics"] == on[1]["metrics"]
