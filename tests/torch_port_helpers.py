"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX package
and the port as arrays; weights are drawn by the JAX package and loaded
into the port through ``switch_nerf_torch.bridge``.
"""
import jax
import jax.numpy as jnp
import numpy as np

from __graft_entry__ import _building_hparams


def tiny_building_hparams(width=16):
    """The tiny Building config (_building_hparams(tiny=True)) with eval in
    padded dispatch, fp32 (--no_amp) and the background NeRF on. `width`
    resizes the trunk (16 in the graft entry; the card's kernels take
    64/128/256)."""
    h = _building_hparams(tiny=True)
    h.moe_test_batch = True
    h.amp = False
    h.bg_nerf = True
    layers = h.model["layers"]
    for tag in ("xyz", "0", "1", "moe_external_gate", "gate_input_norm"):
        for key in ("in_ch", "h_ch", "out_ch", "gate_dim"):
            if layers[tag].get(key) == 16:
                layers[tag][key] = width
    layers["xyz"]["in_ch"] = 3 + h.pos_xyz_dim * 3 * 2
    layers["2"]["in_ch"] = width + 3 + h.pos_dir_dim * 3 * 2 \
        + h.appearance_dim
    layers["sigma"]["in_ch"] = width
    return h


def jax_params(h, model, bg_model, seed=0):
    from switch_nerf_tpu.trainer import create_train_state
    state = create_train_state(jax.random.PRNGKey(seed), h, model, bg_model)
    return state.params, jax.tree_util.tree_map(np.asarray, state.params)


def ray_batch(n, seed=0, n_images=8):
    """Rays from inside the unit sphere (the graft entry's _make_batch
    recipe, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 0.1
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.5), np.full((n, 1), 2.5)],
                          -1).astype(np.float32)
    idx = rng.integers(0, n_images, n).astype(np.float32)
    return {"rays": rays, "image_indices": idx}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}
