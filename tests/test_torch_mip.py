"""The port's mip path vs the JAX package's, on the CPU: ``mip_encode``,
``mip_cast_rays``, ``sorted_piecewise_constant_pdf``, the ``MipNeRFMoE``
forward from bridged weights, and ``render_rays_mip`` in eval and in
training, at the tiny Bungee config (bungee.yaml cut to a 3-layer MoE of
width 64, 9 + 9 samples, no-drop dispatch).

Inputs are made with numpy from a seed. The JAX package draws its
training randomness from split PRNG keys; the test draws the same uniforms
from those keys and hands them to the port (``draws=``), so both sides
see the same numbers. Tolerances: encodings, frustums and the forward
1e-5 (elementwise float32, products in another order); the resampling and
the renders 1e-4 (an interval search whose edges come from cumulative
sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu import trainer as jtrainer
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_tpu.ops import encoding as jenc
from switch_nerf_tpu.render import rendering_mip as jmip
from switch_nerf_torch import bridge
from switch_nerf_torch import trainer as ttrainer
from switch_nerf_torch.models import model_utils as tmu
from switch_nerf_torch.ops import encoding as tenc
from switch_nerf_torch.render import rendering_mip as tmip
from tests.torch_port_helpers import jax_train_state, tiny_bungee_hparams

N_IMAGES = 17


def _close(out, ref, tol, rel=False, err_msg=""):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = max(np.abs(ref).max(), 1e-30) if rel else 1.0
    err = np.abs(out - ref).max()
    assert err <= tol * scale, (err_msg, err, tol * scale)


def _rays(n, seed):
    """Bungee-like rays: origins near the ENU origin 0.07 up, unit
    directions looking down, per-ray near/far and small radii."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.01, (n, 3)) + [0.0, 0.0, 0.07]
    d = rng.normal(0, 0.2, (n, 3)) + [0.0, 0.0, -1.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = rng.uniform(0.03, 0.05, (n, 1))
    far = near + rng.uniform(0.03, 0.06, (n, 1))
    rays = np.concatenate([o, d, near, far], -1).astype(np.float32)
    radii = rng.uniform(1e-4, 1e-3, (n, 1)).astype(np.float32)
    return rays, radii


@pytest.mark.parametrize("num_freqs", [0, 4, 10])
def test_mip_encode_matches_jax(num_freqs):
    rng = np.random.default_rng(num_freqs)
    mean_cov = np.concatenate([rng.normal(0, 1, (50, 3)),
                               rng.uniform(0, 1e-3, (50, 3))],
                              -1).astype(np.float32)
    ref = jenc.mip_encode(jnp.asarray(mean_cov), num_freqs)
    out = tenc.mip_encode(torch.from_numpy(mean_cov), num_freqs)
    assert out.shape == ref.shape
    _close(out, ref, 1e-5)


def test_mip_cast_rays_matches_jax():
    rays, radii = _rays(40, seed=1)
    t = np.sort(np.random.default_rng(2).uniform(
        rays[:, 6:7], rays[:, 7:8], (40, 10)), -1).astype(np.float32)
    args = (rays[:, :3], rays[:, 3:6], radii, t)
    jm, jc = jmip.mip_cast_rays(*map(jnp.asarray, args))
    tm, tc = tmip.mip_cast_rays(*map(torch.from_numpy, args))
    _close(tm, jm, 1e-5, rel=True, err_msg="mean")
    _close(tc, jc, 1e-5, rel=True, err_msg="cov")


@pytest.mark.parametrize("randomized", [False, True])
def test_sorted_piecewise_constant_pdf_matches_jax(randomized):
    rng = np.random.default_rng(3)
    n, b, t = 30, 12, 17
    bins = np.sort(rng.uniform(0, 1, (n, b + 1)), -1).astype(np.float32)
    weights = rng.uniform(0, 1, (n, b)).astype(np.float32)
    weights[0] = 0.0                       # the eps padding of an empty ray
    key = jax.random.PRNGKey(4)
    ref = jmip.sorted_piecewise_constant_pdf(
        jnp.asarray(bins), jnp.asarray(weights), t, randomized, key)
    u = np.array(jax.random.uniform(key, [n, t])) if randomized else None
    out = tmip.sorted_piecewise_constant_pdf(
        torch.from_numpy(bins), torch.from_numpy(weights), t, randomized,
        u=None if u is None else torch.from_numpy(u))
    _close(out, ref, 1e-4)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The tiny Bungee MipNeRFMoE from JAX's init, bridged into the port."""
    h = tiny_bungee_hparams(tmp_path_factory.mktemp("unused"), "unused")
    jm = jmu.get_nerf(h, N_IMAGES)
    params = jax_train_state(jax.random.PRNGKey(0), h, jm, None).params
    tm = tmu.get_nerf(h, N_IMAGES, device="cpu")
    bridge.load_jax_params(tm, jax.tree_util.tree_map(np.asarray,
                                                      params["nerf"]))
    return h, jm, params, tm


def test_mip_nerf_moe_forward_matches_jax(models):
    h, jm, params, tm = models
    assert tm.use_mip and h.appearance_dim == 0
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.normal(0, 0.05, (300, 3)),
                          rng.uniform(0, 1e-5, (300, 3)),
                          rng.normal(0, 1, (300, 3))], -1).astype(np.float32)
    ref = jm.apply({"params": params["nerf"]}, jnp.asarray(pts))
    with torch.no_grad():
        out = tm(torch.from_numpy(pts))
    _close(out["outputs"], ref["outputs"], 1e-5, err_msg="outputs")
    _close(out["extras"]["moe_loss"], ref["extras"]["moe_loss"], 1e-5,
           rel=True, err_msg="moe_loss")


@pytest.mark.parametrize("train", [False, True])
def test_render_rays_mip_matches_jax(models, train):
    """Eval (deterministic) and training (stratified jitter, random
    resampling offsets and random background colours from JAX's keys)."""
    h, jm, params, tm = models
    h = type(h)(**vars(h))
    h.use_random_background_color = train
    rays, radii = _rays(32, seed=6)
    key = jax.random.PRNGKey(7)
    jcfg = jtrainer.render_config_from_hparams(h)
    ref = jmip.render_rays_mip(
        jtrainer.make_model_fn(jm, params["nerf"]), jnp.asarray(rays),
        jnp.asarray(radii), None, jcfg, key, train=train, get_depth=True,
        get_depth_variance=True)

    draws = None
    if train:
        r_perturb, r_fine, _, _, r_bkgd_c, r_bkgd_f = jax.random.split(key, 6)
        draws = {k: torch.from_numpy(np.array(v)) for k, v in (
            ("perturb", jax.random.uniform(
                r_perturb, (32, h.coarse_samples), dtype=jnp.float32)),
            ("fine", jax.random.uniform(r_fine, [32, h.fine_samples])),
            ("bkgd_coarse", jax.random.uniform(r_bkgd_c, (3,), jnp.float32)),
            ("bkgd_fine", jax.random.uniform(r_bkgd_f, (3,), jnp.float32)))}
    with torch.no_grad():
        out = tmip.render_rays_mip(
            ttrainer.make_model_fn(tm), torch.from_numpy(rays),
            torch.from_numpy(radii), None,
            ttrainer.render_config_from_hparams(h), train=train,
            get_depth=True, get_depth_variance=True, draws=draws)
    assert sorted(out) == sorted(ref)
    for k in ref:
        _close(out[k], ref[k], 1e-4, rel=k.startswith("depth"), err_msg=k)
