"""Bridged port models vs the JAX package's, on the CPU, in fp32.

The JAX package initialises the tiny Building models; bridge.load_jax_state
copies the weights into the port's. Tolerance 1e-5 (fp32 matmuls sum in
another order; routing plans come out identical).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import bridge
from switch_nerf_torch.models import model_utils as tmu
from switch_nerf_torch.models.mlp import Mlp
from tests.torch_port_helpers import jax_params, tiny_building_hparams


@pytest.fixture(scope="module")
def models():
    h = tiny_building_hparams()
    jm, jbg = jmu.get_nerf(h, 8), jmu.get_bg_nerf(h, 8)
    params, np_params = jax_params(h, jm, jbg)
    tm = tmu.get_nerf(h, 8, device="cpu")
    tbg = tmu.get_bg_nerf(h, 8, device="cpu")
    bridge.load_jax_state(tm, tbg, np_params)
    return h, jm, jbg, params, tm, tbg


def _points(n, xyz_dim, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (n, xyz_dim))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    idx = rng.integers(0, 8, (n, 1))
    return np.concatenate([xyz, d, idx], -1).astype(np.float32)


def test_nerf_moe_forward_matches_jax(models):
    h, jm, _, params, tm, _ = models
    pts = _points(300, 3, seed=1)
    jout = jm.apply({"params": params["nerf"]}, jnp.asarray(pts))
    with torch.no_grad():
        tout = tm(torch.from_numpy(pts))
    np.testing.assert_allclose(tout["outputs"].numpy(),
                               np.asarray(jout["outputs"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tout["extras"]["moe_loss"].numpy(),
                               np.asarray(jout["extras"]["moe_loss"]),
                               rtol=1e-6)


def test_bg_nerf_forward_matches_jax(models):
    _, _, jbg, params, _, tbg = models
    pts = _points(300, 4, seed=2)
    jout = jbg.apply({"params": params["bg_nerf"]}, jnp.asarray(pts))
    with torch.no_grad():
        tout = tbg(torch.from_numpy(pts))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def test_bridge_consumes_every_leaf(models):
    h = models[0]
    np_params = jax.tree_util.tree_map(np.asarray, models[3])
    tm = tmu.get_nerf(h, 8, device="cpu")
    extra = dict(np_params["nerf"], stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="stray"):
        bridge.load_jax_params(tm, extra)
    missing = {k: v for k, v in np_params["nerf"].items()
               if k != "layer_sigma"}
    with pytest.raises(KeyError, match="layer_sigma"):
        bridge.load_jax_params(tm, missing)
    with pytest.raises(KeyError, match="bg_nerf"):
        bridge.load_jax_state(tm, None, np_params)


def test_port_init_follows_torch_defaults():
    """U(+-1/sqrt(fan_in)) weights and biases, from an explicit generator:
    the same seed gives the same weights."""
    a = Mlp(64, 32, 8, 2, generator=torch.Generator().manual_seed(0))
    b = Mlp(64, 32, 8, 2, generator=torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
        fan_in = 64 if name.startswith("fc0") else 32
        assert p.abs().max() <= fan_in ** -0.5


def test_nerf_moe_and_bg_forwards_with_sigma_noise_match_jax(models):
    """The same injected sigma_noise [S, 1] in train mode: NeRFMoE (padded
    train dispatch) and the bg NeRF to 1e-5, and the noise moves sigma."""
    _, jm, jbg, params, tm, tbg = models
    for jmod, tmod, p, xyz_dim in ((jm, tm, params["nerf"], 3),
                                   (jbg, tbg, params["bg_nerf"], 4)):
        pts = _points(300, xyz_dim, seed=5 + xyz_dim)
        noise = np.random.default_rng(xyz_dim).normal(
            size=(300, 1)).astype(np.float32)
        jout = jmod.apply({"params": p}, jnp.asarray(pts),
                          sigma_noise=jnp.asarray(noise),
                          deterministic=False)
        with torch.no_grad():
            tout = tmod(torch.from_numpy(pts),
                        sigma_noise=torch.from_numpy(noise), train=True)
            plain = tmod(torch.from_numpy(pts))
        if isinstance(jout, dict):
            jout, tout, plain = (jout["outputs"], tout["outputs"],
                                 plain["outputs"])
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=1e-5)
        assert not np.allclose(tout[:, 3].numpy(), plain[:, 3].numpy())


@pytest.mark.parametrize("flag,value", [
    ("moe_train_batch", False), ("gate_noise", 1.0)])
def test_training_what_the_port_lacks_raises(models, flag, value):
    """What earlier slices lacked now trains. No-drop train dispatch (no
    --moe_train_batch): its train state builds and its train-mode forward
    equals the no-drop eval forward (no noise, so the two modes route and
    compute alike). Gate noise: the train state builds, a train-mode
    forward differs from the eval forward, and two draws from the same
    generator state are equal."""
    from switch_nerf_torch import trainer as ttrainer
    h = models[0]
    hx = type(h)(**vars(h))
    setattr(hx, flag, value)
    tm = tmu.get_nerf(hx, 8, device="cpu")
    pts = torch.from_numpy(_points(64, 3, seed=9))
    with torch.no_grad():
        out = tm(pts)["outputs"]                  # eval still runs
    assert torch.isfinite(out).all()
    state = ttrainer.create_train_state(hx, tm, None, device="cpu")
    if flag == "moe_train_batch":
        hx.moe_test_batch = False
        nodrop_eval = tmu.get_nerf(hx, 8, device="cpu")
        nodrop_eval.load_state_dict(tm.state_dict())
        with torch.no_grad():
            train_out = tm(pts, train=True)["outputs"]
            eval_out = nodrop_eval(pts)["outputs"]
        assert torch.equal(train_out, eval_out)
        return
    g = state.generator
    saved = g.get_state()
    with torch.no_grad():
        first = tm(pts, train=True, generator=g)
        g.set_state(saved)
        again = tm(pts, train=True, generator=g)
    assert not torch.equal(first["outputs"], out)
    assert torch.equal(first["outputs"], again["outputs"])
    assert torch.equal(first["extras"]["moe_loss"],
                       again["extras"]["moe_loss"])
