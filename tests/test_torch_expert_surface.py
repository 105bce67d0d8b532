"""The rest of the MoE layer's surface and the oracle models, port vs the
JAX package, on the CPU.

  * the residual MoE (--moe_use_residual: a one-expert
    ``residual_expert`` blended by a softmax ``coefficient``) and the ffn
    experts (--moe_expert_type ffn) at H == M (the L = 2 chain's plain
    version, K1/K2 and K1R/K2R on the card) and H != M (batched
    products), padded and no-drop: forward 1e-5, the gradients of x, the
    gate input and every leaf within 1e-5 of the leaf's largest entry;
  * an MoE background (--bg_use_cfg --bg_use_moe with a --model_bg of
    Building's trunk on a 4-D xyz stem) in two train steps at the tiny
    Building config: every metric and parameter within 1e-4
    (tests/test_torch_train.py's rule), and its checkpoint with residual
    ffn layers written back byte for byte;
  * ``MegaNeRF`` blended (margin 1.15) and hard (margin 1), 2-D
    clusters and xyz_real: outputs 1e-5;
  * ``MaskedMoELayer`` against JAX's and against the port's ``MoELayer``
    at capacity factor E, where padding drops nothing: outputs 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu.models.mega_nerf import MegaNeRF as JMegaNeRF
from switch_nerf_tpu.models.moe_reference import \
    MaskedMoELayer as JMaskedMoELayer
from switch_nerf_tpu.models.nerf import NeRF as JNeRF
from switch_nerf_torch import bridge
from switch_nerf_torch.models.experts import FFNExperts
from switch_nerf_torch.models.mega_nerf import MegaNeRF as TMegaNeRF
from switch_nerf_torch.models.moe import MoELayer as TMoELayer
from switch_nerf_torch.models.moe_reference import \
    MaskedMoELayer as TMaskedMoELayer
from switch_nerf_torch.models.nerf import NeRF as TNeRF
from switch_nerf_torch.models.nerf_moe import NeRFMoE
from tests.test_torch_gating import E, LAYERS, M, SKIPS, _close, _data
from tests.test_torch_gating import compare_layer, moe_pair
from tests.test_torch_train import (_compare, jax_setup, port_state,
                                    port_step, train_batch, train_hparams)
from tests.torch_port_helpers import checkpoint_bytes_both_ways

LAYER_CASES = {
    "residual": dict(use_residual=True),
    "ffn_square": dict(expert_type="ffn", ffn_hidden_size=M),
    "ffn_wide": dict(expert_type="ffn", ffn_hidden_size=2 * M),
}


@pytest.mark.parametrize("dispatch", ["padded", "nodrop"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_matches_jax(case, dispatch):
    x, gi = _data(seed=11)
    jlayer, params, tlayer = moe_pair(
        x, gi, train_dispatch=dispatch, eval_dispatch=dispatch,
        **LAYER_CASES[case])
    if case.startswith("ffn"):
        assert isinstance(tlayer.experts, FFNExperts)
        assert sorted(params["params"]["experts"]) == ["b1", "b2", "w1",
                                                       "w2"]
    else:
        assert sorted(params["params"]) == ["coefficient", "experts",
                                            "residual_expert", "wg"]
    compare_layer(jlayer, params, tlayer, x, gi, train=True)
    with torch.no_grad():
        ty, _, _ = tlayer(torch.from_numpy(x), torch.from_numpy(gi))
    jy, _, _ = jlayer.apply(params, jnp.asarray(x), jnp.asarray(gi))
    _close(ty, jy, 1e-5, err_msg="eval forward")


def test_ffn_init_follows_jax():
    """Fan-in M for w1 and b1, H for w2 and b2, no init_factor."""
    f = FFNExperts(16, 3, 64, generator=torch.Generator().manual_seed(0))
    assert f.w1.shape == (3, 16, 64) and f.b2.shape == (3, 1, 16)
    for p, fan_in in ((f.w1, 16), (f.b1, 16), (f.w2, 64), (f.b2, 64)):
        assert p.abs().max() <= fan_in ** -0.5
        assert p.abs().max() > 0.9 * fan_in ** -0.5


def bg_moe_hparams(residual=False, ffn=False):
    h = train_hparams()
    h.bg_use_cfg = h.bg_use_moe = True
    h.model_bg = copy.deepcopy(h.model)
    h.model_bg["layers"]["xyz"]["in_ch"] = 4 + h.pos_xyz_dim * 4 * 2
    h.moe_use_residual = residual
    h.moe_expert_type = "ffn" if ffn else "expertmlp"
    return h


def test_bg_moe_train_steps_match_jax():
    h = bg_moe_hparams()
    jstate, jstep = jax_setup(h)
    tstate = port_state(h, jax.tree_util.tree_map(np.asarray,
                                                  jstate.params))
    assert isinstance(tstate.bg_model, NeRFMoE)
    tstep = port_step(h)
    for i in range(2):
        batch = train_batch(300, seed=20 + i)
        jstate, jmet = jstep(jstate, to_jax(batch))
        tstate, tmet = tstep(tstate, batch)
        assert "bg_gate_loss" in tmet and float(tmet["bg_gate_loss"]) > 0
        _compare(jmet, tmet, jstate.params, tstate, 1e-4, 1e-4)


def test_checkpoint_bytes_both_ways(tmp_path):
    """Residual ffn MoE layers in the fg and an MoE background: every
    new leaf (residual_expert/w*, coefficient, experts/w1..b2, the bg
    experts) through the bridge, both ways."""
    h = bg_moe_hparams(residual=True, ffn=True)
    want, got, restored, jtree = checkpoint_bytes_both_ways(h, tmp_path)
    assert got == want
    layer = restored["bg_nerf"]["layer_0"]
    assert sorted(layer) == ["coefficient", "experts", "residual_expert",
                             "wg"]
    assert sorted(layer["experts"]) == ["b1", "b2", "w1", "w2"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, restored, jtree)


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


CENTROIDS = ((0.0, 0.0, 0.0), (0.6, 0.3, -0.2), (-0.5, 0.4, 0.5))


@pytest.mark.parametrize("margin,cluster_2d,xyz_real", [
    (1.15, False, False), (1.0, False, False), (1.5, True, False),
    (1.15, False, True)])
def test_mega_nerf_matches_jax(margin, cluster_2d, xyz_real):
    kw = dict(pos_xyz_dim=2, pos_dir_dim=1, layers=2, skip_layers=(),
              layer_dim=16, appearance_dim=0, xyz_dim=3)
    n = len(CENTROIDS)
    jm = JMegaNeRF(sub_modules=[JNeRF(**kw) for _ in range(n)],
                   centroids=CENTROIDS, boundary_margin=margin,
                   cluster_2d=cluster_2d, xyz_real=xyz_real)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (120, 6)).astype(np.float32)
    if xyz_real:
        x = np.concatenate([x[:, :3], x], -1)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = TMegaNeRF([TNeRF(**kw) for _ in range(n)], CENTROIDS,
                   boundary_margin=margin, cluster_2d=cluster_2d,
                   xyz_real=xyz_real)
    bridge.load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        w = tm.weights(torch.from_numpy(x))
    _close(got, want, 1e-5)
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, rtol=1e-6)
    if margin == 1.0:
        assert set(np.unique(w.numpy())) == {0.0, 1.0}
    else:
        assert ((w > 0).sum(1) > 1).any()


@pytest.mark.parametrize("postscore", [True, False])
def test_masked_moe_matches_jax_and_the_layer(postscore):
    x, gi = _data(seed=13)
    kw = dict(model_dim=M, num_experts=E, layer_num=LAYERS, skips=SKIPS,
              is_postscore=postscore)
    jlayer = JMaskedMoELayer(**kw)
    params = jlayer.init(jax.random.PRNGKey(2), jnp.asarray(x),
                         jnp.asarray(gi))
    tmask = TMaskedMoELayer(**kw)
    bridge.load_jax_params(tmask, jax.tree_util.tree_map(np.asarray,
                                                         params["params"]))
    jy, jl, _ = jlayer.apply(params, jnp.asarray(x), jnp.asarray(gi))
    tlayer = TMoELayer(capacity_factor=float(E), **kw)
    tlayer.load_state_dict(tmask.state_dict())
    with torch.no_grad():
        my, ml, _ = tmask(torch.from_numpy(x), torch.from_numpy(gi))
        ly, ll, _ = tlayer(torch.from_numpy(x), torch.from_numpy(gi))
    _close(my, jy, 1e-5, err_msg="masked vs JAX")
    _close(ly, my, 1e-5, err_msg="layer vs masked")
    np.testing.assert_allclose(float(ml), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(ll), float(ml), rtol=1e-6)
