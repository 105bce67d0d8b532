"""Top-k routing, gate noise and the auxiliary losses of the port vs the
JAX package, on the CPU.

  * ``ops/routing.extract_critical`` at k = 2 and 3, with and without
    batch-prioritized routing, over gates with exact ties (the lower
    expert first, as ``jax.lax.top_k``): indices, locations, counts and
    capacity equal, gates within 1e-6, l_aux within 1e-6 relative;
  * the MoE layer at k = 2, padded and no-drop dispatch: forward 1e-5,
    the gradients of x, the gate input and every leaf within 1e-5 of the
    leaf's largest entry;
  * gate noise with the load-importance loss, the balance loss and the
    gate logits in train mode. The two packages draw from different
    generators, so JAX's normal draw is made by a stand-in for
    ``jax.random.normal`` (monkeypatched in this test) and the same array
    is handed to the port's ``MoELayer.noise``: outputs, l_aux, the
    balance loss and the logits within 1e-5, gradients as above; the loss
    raises without noise, as in JAX.

Inputs and weights are made with numpy from a seed; the JAX parameters go
to the port through ``switch_nerf_torch.bridge``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu.models.moe import MoELayer as JMoELayer
from switch_nerf_tpu.ops import routing as jrouting
from switch_nerf_torch import bridge
from switch_nerf_torch.models.moe import MoELayer as TMoELayer
from switch_nerf_torch.ops import routing as trouting

M, E, LAYERS, SKIPS = 32, 4, 3, (1,)


def _close(out, ref, tol, rel=False, err_msg=""):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max() if rel else 1.0
    err = np.abs(out - ref).max()
    assert err <= tol * scale, (err_msg, err, tol * scale)


def _gates(s, e, seed):
    """Softmax gates whose logits repeat values, so some tokens tie."""
    rng = np.random.default_rng(seed)
    logits = rng.integers(0, 3, (s, e)).astype(np.float32)
    logits[: s // 2] += rng.normal(0, 1, (s // 2, e)).astype(np.float32)
    g = np.exp(logits - logits.max(1, keepdims=True))
    return (g / g.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("bpr", [False, True])
def test_topk_plans_match_jax(k, bpr):
    gates = _gates(200, 6, seed=k + 10 * bpr)
    jplan, jl = jrouting.extract_critical(jnp.asarray(gates), k, 1.0, bpr)
    tplan, tl = trouting.extract_critical(torch.from_numpy(gates), k, 1.0,
                                          bpr)
    assert tplan.capacity == jplan.capacity == k * 34
    for name in ("indices", "locations", "expert_counts"):
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    _close(tplan.gates, jplan.gates, 1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    # some tokens' top gates tie: the lower expert comes first
    assert (np.sort(gates, 1)[:, -1] == np.sort(gates, 1)[:, -2]).any()


def moe_pair(x, gi, seed=0, **kw):
    """The JAX and port MoE layers with the same weights."""
    kw = dict(dict(model_dim=M, num_experts=E, layer_num=LAYERS, skips=SKIPS,
                   capacity_factor=1.0, batch_prioritized_routing=True),
              **kw)
    jlayer = JMoELayer(**kw)
    params = jlayer.init({"params": jax.random.PRNGKey(seed),
                          "gate_noise": jax.random.PRNGKey(seed)},
                         jnp.asarray(x), jnp.asarray(gi))
    params = jax.tree_util.tree_map(np.array, params)
    tkw = {k: v for k, v in kw.items() if k != "use_normal_noise"}
    tlayer = TMoELayer(**tkw)
    bridge.load_jax_params(tlayer, params["params"])
    return jlayer, params, tlayer


def port_grads(module):
    """{flax path: gradient in flax layout} of a port module."""
    return {path: bridge._to_flax(p.grad, path)
            for path, p in bridge._flax_leaves(module)}


def compare_layer(jlayer, params, tlayer, x, gi, train, rngs=None,
                  aux_keys=(), tol=1e-5):
    """Forward (y, l_aux, the named extras) and the gradients of
    sum(y * w) + 3 l_aux in both packages."""
    w_out = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx, gg):
        y, l_aux, extras = jlayer.apply(p, xx, gg, deterministic=not train,
                                        rngs=rngs)
        return jnp.sum(y * w_out) + 3.0 * l_aux, (y, l_aux, extras)

    (_, (jy, jl, jex)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            params, jnp.asarray(x), jnp.asarray(gi))
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(gi).requires_grad_()
    y, l_aux, extras = tlayer(tx, tg, train=train)
    (torch.sum(y * torch.from_numpy(w_out)) + 3.0 * l_aux).backward()
    _close(y.detach(), jy, tol, err_msg="forward")
    np.testing.assert_allclose(float(l_aux.detach()), float(jl), rtol=tol)
    for key in aux_keys:
        _close(extras[key].detach(), jex[key], tol, err_msg=key)
    _close(tx.grad, jg[1], tol, rel=True, err_msg="dx")
    _close(tg.grad, jg[2], tol, rel=True, err_msg="d gate input")
    got = port_grads(tlayer)
    want = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(
                jg[0]["params"])}
    assert sorted(got) == sorted(want)
    for path in want:
        _close(got[path], want[path], tol, rel=True, err_msg=path)
    return extras, jex


def _data(s=96, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (s, M)).astype(np.float32),
            rng.normal(0, 1, (s, M)).astype(np.float32))


@pytest.mark.parametrize("dispatch", ["padded", "nodrop"])
def test_top2_layer_matches_jax(dispatch):
    x, gi = _data()
    jlayer, params, tlayer = moe_pair(
        x, gi, top_k=2, train_dispatch=dispatch, eval_dispatch=dispatch,
        return_gates=True)
    extras, jex = compare_layer(jlayer, params, tlayer, x, gi, train=True,
                                aux_keys=("gates",))
    assert extras["gates"].shape == (96, 2)
    with torch.no_grad():
        ty, _, _ = tlayer(torch.from_numpy(x), torch.from_numpy(gi))
    jy, _, _ = jlayer.apply(params, jnp.asarray(x), jnp.asarray(gi))
    _close(ty, jy, 1e-5, err_msg="eval forward")


class _Draws:
    """A stand-in for jax.random.normal that returns numpy normal draws
    from a seed, call by call, and keeps them for the port's hook."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.made = []

    def __call__(self, key, shape, dtype=jnp.float32):
        a = self.rng.normal(size=shape).astype(np.float32)
        self.made.append(a)
        return jnp.asarray(a, dtype)


@pytest.mark.parametrize("k", [1, 2])
def test_gate_noise_and_load_importance_match_jax(k, monkeypatch):
    x, gi = _data(seed=5)
    jlayer, params, tlayer = moe_pair(
        x, gi, top_k=k, gate_noise=1.0, use_load_importance_loss=True,
        compute_balance_loss=True, return_gate_logits=True,
        return_gates=True)
    draws = _Draws(seed=k)
    monkeypatch.setattr(jax.random, "normal", draws)
    # the JAX layer runs first (compare_layer): the port takes its draw
    tlayer.noise = lambda logits, generator: torch.from_numpy(draws.made[-1])
    extras, _ = compare_layer(
        jlayer, params, tlayer, x, gi, train=True,
        rngs={"gate_noise": jax.random.PRNGKey(3)},
        aux_keys=("balance_loss", "gate_logits", "gates"))
    assert len(draws.made) == 1 and draws.made[0].shape == (96, E)
    assert float(extras["balance_loss"]) > 0
    # the noise moved some tokens; eval draws nothing
    with torch.no_grad():
        plain, l_plain, ex_plain = tlayer(torch.from_numpy(x),
                                          torch.from_numpy(gi))
    assert not torch.equal(ex_plain["gates"], extras["gates"])
    jy, jl, _ = jlayer.apply(params, jnp.asarray(x), jnp.asarray(gi))
    assert len(draws.made) == 1
    _close(plain, jy, 1e-5, err_msg="eval forward")
    np.testing.assert_allclose(float(l_plain), float(jl), rtol=1e-5)


def test_load_importance_loss_needs_noise():
    scores = torch.softmax(torch.randn(16, 4), 1)
    with pytest.raises(ValueError, match="gate_noise"):
        trouting.load_importance_loss(scores, scores[:, :1], 4, 0.0)
    with pytest.raises(ValueError, match="gate_noise"):
        jrouting.load_importance_loss(jnp.asarray(scores.numpy()),
                                      jnp.asarray(scores[:, :1].numpy()),
                                      4, 0.0)
    a = trouting.load_importance_loss(scores, scores[:, :2], 4, 0.5)
    b = jrouting.load_importance_loss(jnp.asarray(scores.numpy()),
                                      jnp.asarray(scores[:, :2].numpy()),
                                      4, 0.5)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
