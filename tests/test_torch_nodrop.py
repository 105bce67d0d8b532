"""No-drop MoE dispatch of the port vs the JAX package's, on the CPU.

``ExpertMLP.ragged`` (the port's ragged chain, K1R/K2R's plain versions on
the CPU) against JAX's ``ExpertMLP.ragged`` (``jax.lax.ragged_dot``), and
the no-drop ``MoELayer`` (sort by expert, ragged chain, inverse
permutation) against JAX's ``_nodrop_path``, forward and gradients, with
one expert routed no token. Inputs are made with numpy from a seed; the
JAX parameters go to the port through ``switch_nerf_torch.bridge``.

Tolerances (fp32): forward 1e-5; gradients 1e-5 of each leaf's largest
entry (products and sums in another order). The plain backward is held
against autograd through the plain forward to 1e-6 (the same operations).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu.models.experts import ExpertMLP as JExpertMLP
from switch_nerf_tpu.models.moe import MoELayer as JMoELayer
from switch_nerf_torch import bridge
from switch_nerf_torch.models.experts import ExpertMLP as TExpertMLP
from switch_nerf_torch.models.moe import MoELayer as TMoELayer
from switch_nerf_torch.ops import ragged_chain

M, E, LAYERS, SKIPS = 64, 4, 3, (1,)


def _close(out, ref, tol, rel=False, err_msg=""):
    """max |out - ref| <= tol (times max |ref| when rel)."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max() if rel else 1.0
    err = np.abs(out - ref).max()
    assert err <= tol * scale, (err_msg, err, tol * scale)


def _ragged_inputs(counts, seed):
    rng = np.random.default_rng(seed)
    n = int(sum(counts))
    x = rng.normal(0, 1, (n, M)).astype(np.float32)
    row_expert = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    g = rng.normal(0, 1, (n, M)).astype(np.float32)
    return x, np.asarray(counts, np.int32), row_expert, g


@pytest.mark.parametrize("counts", [[5, 0, 17, 9], [0, 0, 31, 0],
                                    [40, 1, 1, 1]])
def test_expert_mlp_ragged_matches_jax(counts):
    """Forward and the gradients of x and every expert leaf, one or more
    experts with no rows (their dW and db are exactly zero)."""
    x, cnt, row_expert, g = _ragged_inputs(counts, seed=sum(counts))
    jm = JExpertMLP(model_dim=M, num_experts=E, layer_num=LAYERS,
                    skips=SKIPS)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(cnt),
                     jnp.asarray(row_expert), method=JExpertMLP.ragged)

    def jloss(p, xx):
        y = jm.apply(p, xx, jnp.asarray(cnt), jnp.asarray(row_expert),
                     method=JExpertMLP.ragged)
        return jnp.sum(y * g), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(x))

    tm = TExpertMLP(M, E, LAYERS, SKIPS)
    bridge.load_jax_params(tm, jax.tree_util.tree_map(np.asarray,
                                                      params["params"]))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm.ragged(tx, torch.from_numpy(cnt), torch.from_numpy(row_expert))
    _close(ty.detach(), jy, 1e-5, err_msg="forward")
    (ty * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, jgx, 1e-5, rel=True, err_msg="dx")
    for name, p in tm.named_parameters():
        ref = np.asarray(jgp["params"][name])
        _close(p.grad, ref, 1e-5, rel=True, err_msg=name)
        for e, c in enumerate(counts):
            if c == 0:
                assert not p.grad[e].any(), (name, e)


def test_ragged_chain_plain_matches_jax_at_bungee_structure():
    """``ragged_chain_plain`` and ``ragged_chain_bwd_plain``, the versions
    K1R/K2R are held against on the card, against JAX's
    ``ExpertMLP.ragged`` forward and ``jax.grad`` at the structure of
    Bungee's MoE layer: M = 256, L = 7, skip 3, E = 4, fp32, skewed counts
    with an empty expert."""
    _ragged_plain_vs_jax(256, (3,), [0, 37, 301, 90], seed=8)


def test_ragged_chain_plain_matches_jax_at_mission_bay_width():
    """The same at Mission Bay's trunk in fp32 (--no_amp): M = 512, L = 7,
    skip 3, E = 8, skewed counts with empty experts."""
    _ragged_plain_vs_jax(512, (3,), [0, 37, 140, 0, 9, 64, 1, 21], seed=9)


def _ragged_plain_vs_jax(m, skips, counts, seed):
    e, layers = len(counts), 7
    rng = np.random.default_rng(seed)
    n = sum(counts)
    x = rng.normal(0, 1, (n, m)).astype(np.float32)
    g = rng.normal(0, 1, (n, m)).astype(np.float32)
    cnt = np.asarray(counts, np.int32)
    row_expert = np.repeat(np.arange(e), counts).astype(np.int32)
    jm = JExpertMLP(model_dim=m, num_experts=e, layer_num=layers, skips=skips)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(cnt),
                     jnp.asarray(row_expert), method=JExpertMLP.ragged)

    def jloss(p, xx):
        y = jm.apply(p, xx, jnp.asarray(cnt), jnp.asarray(row_expert),
                     method=JExpertMLP.ragged)
        return jnp.sum(y * g), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(x))
    p = params["params"]
    ws = torch.from_numpy(np.stack([np.asarray(p[f"w{i}"])
                                    for i in range(layers)]))
    bs = torch.from_numpy(np.stack([np.asarray(p[f"b{i}"])
                                    for i in range(layers)]))
    tc = torch.from_numpy(cnt)
    y = ragged_chain.ragged_chain_plain(torch.from_numpy(x), tc, ws, bs,
                                        skips)
    _close(y, jy, 1e-5, err_msg="forward")
    dx, dw, db = ragged_chain.ragged_chain_bwd_plain(
        torch.from_numpy(x), tc, ws, bs, torch.from_numpy(g), skips)
    _close(dx, jgx, 1e-5, rel=True, err_msg="dx")
    for i in range(layers):
        _close(dw[i], jgp["params"][f"w{i}"], 1e-5, rel=True,
               err_msg=f"w{i}")
        _close(db[i], jgp["params"][f"b{i}"], 1e-5, rel=True,
               err_msg=f"b{i}")
    empty = [i for i, c in enumerate(counts) if c == 0]
    assert not dw[:, empty].any() and not db[:, empty].any()


@pytest.mark.parametrize("layers,skips", [(1, ()), (4, (1, 3)), (3, (0,))])
def test_ragged_chain_bwd_plain_matches_autograd(layers, skips):
    x, cnt, _, g = _ragged_inputs([7, 0, 12, 3], seed=layers)
    rng = np.random.default_rng(layers + 10)
    ws = torch.from_numpy(rng.normal(0, 0.2, (layers, E, M, M))
                          .astype(np.float32)).requires_grad_()
    bs = torch.from_numpy(rng.normal(0, 0.2, (layers, E, 1, M))
                          .astype(np.float32)).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    y = ragged_chain.ragged_chain_plain(tx, torch.from_numpy(cnt), ws, bs,
                                        skips)
    want = torch.autograd.grad(y, (tx, ws, bs), torch.from_numpy(g))
    got = ragged_chain.ragged_chain_bwd_plain(
        tx.detach(), torch.from_numpy(cnt), ws.detach(), bs.detach(),
        torch.from_numpy(g), skips)
    assert got[1].dtype == got[2].dtype == torch.float32
    for a, b, name in zip(got, want, ("dx", "dW", "db")):
        _close(a, b, 1e-6, rel=True, err_msg=name)


def _moe_data(s=96, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (s, M)).astype(np.float32)
    gi = rng.normal(0, 1, (s, M)).astype(np.float32)
    w_out = rng.normal(size=(s, M)).astype(np.float32)
    return x, gi, w_out


def _moe_pair(x, gi, postscore):
    """The JAX and port no-drop layers with the same weights; expert 2's
    gate column is the mean of experts 0 and 1's, so its logit never
    exceeds both (a tie goes to the lower index) and no token routes to
    it."""
    kw = dict(model_dim=M, num_experts=E, layer_num=LAYERS, skips=SKIPS,
              capacity_factor=1.0, batch_prioritized_routing=True,
              is_postscore=postscore, train_dispatch="nodrop",
              eval_dispatch="nodrop")
    jlayer = JMoELayer(top_k=1, **kw)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(gi))
    params = jax.tree_util.tree_map(np.array, params)       # writable
    kernel = params["params"]["wg"]["kernel"]
    kernel[:, 2] = 0.5 * (kernel[:, 0] + kernel[:, 1])
    tlayer = TMoELayer(**kw)
    bridge.load_jax_params(tlayer, params["params"])
    return jlayer, params, tlayer


@pytest.mark.parametrize("postscore", [True, False])
def test_nodrop_moe_layer_matches_jax(postscore):
    """Eval forward, then train-mode gradients of x, the gate input, the
    gate weight and every expert leaf; expert 2 gets no token (its expert
    gradients are exactly zero on both sides)."""
    x, gi, w_out = _moe_data()
    jlayer, params, tlayer = _moe_pair(x, gi, postscore)
    jy, jl, _ = jlayer.apply(params, jnp.asarray(x), jnp.asarray(gi))
    with torch.no_grad():
        ty, tl, _ = tlayer(torch.from_numpy(x), torch.from_numpy(gi))
    _close(ty, jy, 1e-5, err_msg="eval forward")
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)

    def jloss(p, xx, gg):
        y, l_aux, _ = jlayer.apply(p, xx, gg, deterministic=False)
        return jnp.sum(y * w_out) + 3.0 * l_aux

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(x), jnp.asarray(gi))
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(gi).requires_grad_()
    y, l_aux, _ = tlayer(tx, tg, train=True)
    (torch.sum(y * torch.from_numpy(w_out)) + 3.0 * l_aux).backward()
    counts = np.bincount(np.argmax(np.asarray(jax.nn.softmax(
        gi @ params["params"]["wg"]["kernel"])), 1), minlength=E)
    assert counts[2] == 0 and counts.sum() == x.shape[0]
    _close(tx.grad, jgrads[1], 1e-5, rel=True, err_msg="dx")
    _close(tg.grad, jgrads[2], 1e-5, rel=True, err_msg="d gate input")
    tparams = dict(tlayer.named_parameters())
    for path, ref in jax.tree_util.tree_leaves_with_path(jgrads[0]["params"]):
        name = ".".join(k.key for k in path)
        if name == "wg.kernel":               # [in, out] vs torch's [out, in]
            grad = tparams["wg.weight"].grad.T
        else:
            grad = tparams[name].grad
            assert not grad[2].any(), name
        _close(grad, ref, 1e-5, rel=True, err_msg=name)


def test_nodrop_drops_nothing_where_padded_does():
    """At capacity factor 1 with skewed routing the padded layer drops
    tokens (their output rows are zero) and the no-drop layer does not."""
    x, gi, _ = _moe_data()
    _, params, nodrop = _moe_pair(x, gi, True)
    padded = TMoELayer(model_dim=M, num_experts=E, layer_num=LAYERS,
                       skips=SKIPS, capacity_factor=1.0,
                       batch_prioritized_routing=True)
    bridge.load_jax_params(padded, params["params"])
    with torch.no_grad():
        yp = padded(torch.from_numpy(x), torch.from_numpy(gi))[0]
        yn = nodrop(torch.from_numpy(x), torch.from_numpy(gi))[0]
    dropped = (yp == 0).all(dim=1)
    assert dropped.any() and not (yn == 0).all(dim=1).any()
    torch.testing.assert_close(yn[~dropped], yp[~dropped], rtol=1e-5,
                               atol=1e-5)
