"""The rest of the NeRF model surface in the port vs the JAX package, on
the CPU, in fp32, from bridged parameters: ``eval_sh`` (degrees 0-4, 1e-6),
``NeRFMoE`` and the dense ``NeRF`` with affine appearance, pos_dir_dim 0
(rgb from the sigma head), SH colour heads (--sh_deg), sigma-only queries,
and the layer types normmlp / groupnorm / dropout, in eval and in train
mode (1e-5: fp32 matmuls summed in another order).

Dropout draws differ between the frameworks: the train-mode check reads
JAX's keep mask back from its dropout layer's output (captured
intermediates: the dropped entries are the zeros) and hands it to the
port's layer. batchnorm and a NormMlp norm other than layernorm raise in
both packages, and so does a dense mip NeRF (JAX at init, the port at its
first 6-wide query).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_tpu.ops.encoding import eval_sh as jeval_sh
from switch_nerf_torch import bridge
from switch_nerf_torch.models import model_utils as tmu
from switch_nerf_torch.models.common import Dropout
from switch_nerf_torch.ops.encoding import eval_sh
from tests.torch_port_helpers import jax_params, tiny_building_hparams

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(5, 7, 3, (deg + 1) ** 2)).astype(np.float32)
    d = rng.normal(size=(5, 7, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    want = np.asarray(jeval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))
    got = eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(d)).numpy()
    assert got.shape == want.shape == (5, 7, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _norm_graph(h):
    """The tiny graph with a normmlp trunk layer (layernorm, skip), a
    groupnorm and a dropout before the sigma tap."""
    g = copy.deepcopy(h.model)
    lay = g["layers"]
    dir_layer, color_layer = lay.pop("1"), lay.pop("2")
    lay["1"] = {"in_ch": 16, "h_ch": 16, "out_ch": 16, "num": 3,
                "skips": [1], "type": "normmlp", "norm_name": "layernorm",
                "act": "relu"}
    lay["2"] = {"type": "groupnorm", "group_num": 4, "act": "none"}
    lay["3"] = {"type": "dropout", "prob": 0.25, "act": "none"}
    lay["4"], lay["5"] = dir_layer, color_layer
    g.update(layer_num_main=6, sigma_tag=3, dir_tag=4, color_tag=5)
    return g


def variant(name, moe=True):
    h = tiny_building_hparams()
    h.bg_nerf = False
    h.use_moe = moe
    h.layers, h.skip_layers, h.layer_dim = 3, [1], 16
    if name.startswith("affine"):
        h.affine_appearance = True
    if name in ("affine_nodir", "pos_dir_0", "pos_dir_0_no_app"):
        # the MoE's sigma head then emits rgb and sigma
        h.pos_dir_dim = 0
        h.model["layers"]["sigma"]["out_ch"] = 4
    if name == "pos_dir_0_no_app":
        h.appearance_dim = 0
    elif name == "sh":
        h.sh_deg = 2
        h.model["layers"]["color"]["out_ch"] = 27
    elif name == "norms":
        h.model = _norm_graph(h)
    return h


def _points(n, h, seed, xyz_dim=3):
    rng = np.random.default_rng(seed)
    parts = [rng.uniform(-1, 1, (n, xyz_dim))]
    if h.pos_dir_dim > 0:
        d = rng.normal(size=(n, 3))
        parts.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    if h.appearance_dim > 0:
        parts.append(rng.integers(0, 8, (n, 1)))
    return np.concatenate(parts, -1).astype(np.float32)


def bridged(h):
    """JAX's init of the model, bridged into the port's, and exported back
    (the new leaves: affine, NormMlp's norms, groupnorm's scale and bias,
    the SH heads) leaf for leaf equal."""
    jm = jmu.get_nerf(h, 8)
    params, np_params = jax_params(h, jm, None)
    tm = tmu.get_nerf(h, 8, device="cpu")
    bridge.load_jax_state(tm, None, np_params)
    back = dict(_leaves(bridge.export_jax_state(tm, None)))
    want = dict(_leaves(np_params))
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=str(k))
    return jm, params["nerf"], tm


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _outputs(out):
    return out["outputs"] if isinstance(out, dict) else out


VARIANTS = [(name, moe) for name in ("affine", "affine_nodir", "pos_dir_0",
                                     "pos_dir_0_no_app", "sh")
            for moe in (True, False)] + [("norms", True)]


@pytest.mark.parametrize("name,moe", VARIANTS, ids=[
    f"{n}-{'moe' if m else 'dense'}" for n, m in VARIANTS])
def test_variant_matches_jax(name, moe):
    h = variant(name, moe)
    jm, params, tm = bridged(h)
    pts = _points(200, h, seed=3)
    want = np.asarray(_outputs(jm.apply({"params": params},
                                        jnp.asarray(pts))))
    with torch.no_grad():
        got = _outputs(tm(torch.from_numpy(pts))).numpy()
    rgb_dim = 27 if name == "sh" else 3
    assert got.shape == want.shape == (200, rgb_dim + 1)
    np.testing.assert_allclose(got, want, **TOL)

    # train mode: padded train dispatch, sigma noise, dropout's mask
    noise = np.random.default_rng(9).normal(size=(200, 1)).astype(np.float32)
    jout, state = jm.apply(
        {"params": params}, jnp.asarray(pts), sigma_noise=jnp.asarray(noise),
        deterministic=False, rngs={"dropout": jax.random.PRNGKey(5)},
        capture_intermediates=True, mutable=["intermediates"])
    if name == "norms":
        dropped = np.asarray(state["intermediates"]["layer_3"]
                             ["__call__"][0])
        keep = torch.from_numpy(dropped != 0)
        assert 0 < (~keep).sum() < keep.numel()
        tm.layer_3.keep_mask = lambda x, generator=None: keep
    with torch.no_grad():
        got = _outputs(tm(torch.from_numpy(pts),
                          sigma_noise=torch.from_numpy(noise),
                          train=True)).numpy()
    np.testing.assert_allclose(got, np.asarray(_outputs(jout)), **TOL)


@pytest.mark.parametrize("moe", [True, False], ids=["moe", "dense"])
def test_sigma_only_matches_jax(moe):
    h = variant("base", moe)
    jm, params, tm = bridged(h)
    pts = _points(150, h, seed=4)[:, :3]
    want = np.asarray(_outputs(jm.apply({"params": params}, jnp.asarray(pts),
                                        sigma_only=True)))
    with torch.no_grad():
        got = _outputs(tm(torch.from_numpy(pts), sigma_only=True)).numpy()
    assert got.shape == want.shape == (150, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_dropout_is_train_only_and_scales():
    d = Dropout(0.5)
    x = torch.ones(64, 32)
    assert torch.equal(d(x), x)
    y = d(x, train=True, generator=torch.Generator().manual_seed(0))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(Dropout(1.0)(x, train=True), torch.zeros_like(x))


def test_refusals_match_jax():
    h = variant("norms")
    h.model["layers"]["2"] = {"type": "batchnorm", "act": "none"}
    with pytest.raises(NotImplementedError, match="batchnorm"):
        jax_params(h, jmu.get_nerf(h, 8), None)
    with pytest.raises(NotImplementedError, match="batchnorm"):
        tmu.get_nerf(h, 8, device="cpu")
    h = variant("norms")
    h.model["layers"]["1"]["norm_name"] = "batchnorm"
    with pytest.raises(NotImplementedError):
        jax_params(h, jmu.get_nerf(h, 8), None)
    with pytest.raises(NotImplementedError):
        tmu.get_nerf(h, 8, device="cpu")


def test_dense_mip_nerf_raises_as_jax():
    """JAX builds the dense NeRF for --use_mip without --use_moe and its
    init with the mip input raises; the port builds the same model and its
    first 6-wide (mean, covariance) query raises."""
    h = variant("base", moe=False)
    h.use_mip = True
    with pytest.raises(ValueError, match="Unexpected input shape"):
        jax_params(h, jmu.get_nerf(h, 8), None)
    tm = tmu.get_nerf(h, 8, device="cpu")
    pts = torch.from_numpy(_points(10, h, seed=1, xyz_dim=6))
    with pytest.raises(ValueError, match="Unexpected input shape"):
        tm(pts)
