"""A multi-step training trajectory, port vs JAX, at the production graph.

The exact Building layer graph (configs/switch_nerf/building.yaml: 8
experts x 7 x 256 with skip [3], external gate, gate-input LayerNorm,
appearance_dim 48) in padded train dispatch (--moe_train_batch), fp32, no
background NeRF, perturb 0, 8 + 8 samples. One JAX init, bridged into the
port; 6 steps of 32 rays (tests/test_training_parity.py's batch recipe,
seed 29) through both packages' make_train_step, Adam at lr 2e-3 decaying
to a tenth over the 6 steps, l_aux weight 0.01.

Bands: the JAX package's own production-width pin against the reference
(tests/test_training_parity.py:638-640): all_loss within 5e-4 relative at
steps 0-1 and 5e-3 at steps 0-2, median within 8e-2 (padded drop sets flip
at the capacity boundary, so later steps agree statistically).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from switch_nerf_tpu import config as jconfig
from switch_nerf_tpu import trainer as jtrainer
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import bridge
from switch_nerf_torch import config as tconfig
from switch_nerf_torch import trainer as ttrainer
from switch_nerf_torch.models import model_utils as tmu

STEPS = 6
BUILDING = Path(__file__).resolve().parent.parent / "configs" / \
    "switch_nerf" / "building.yaml"
FLAGS = [
    "--config_file", str(BUILDING),
    "--exp_name", "traj", "--dataset_path", "unused",
    "--use_moe", "--use_moe_external_gate", "--use_gate_input_norm",
    "--batch_prioritized_routing", "--moe_capacity_factor", "1.0",
    "--moe_expert_num", "8", "--moe_train_batch", "--no_bg_nerf",
    "--no_amp", "--perturb", "0.0", "--coarse_samples", "8",
    "--fine_samples", "8", "--model_chunk_size", "4096", "--lr", "2e-3",
    "--lr_decay_factor", "0.1", "--train_iterations", str(STEPS),
    "--moe_l_aux_wt", "0.01"]


def make_batches(n_steps, n_rays=32, n_batches=8, seed=29):
    """tests/test_training_parity.py's _make_batches: rays from near the
    origin, a direction-dependent target colour, 4 appearance rows."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        o = rng.normal(0, 0.2, (n_rays, 3)).astype(np.float32)
        d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        rays = np.concatenate(
            [o, d, np.full((n_rays, 1), 0.1, np.float32),
             np.full((n_rays, 1), 2.0, np.float32)], -1)
        idx = rng.integers(0, 4, (n_rays,)).astype(np.float32)
        rgbs = (0.5 + 0.5 * d).astype(np.float32)
        batches.append({"rays": rays, "image_indices": idx, "rgbs": rgbs})
    return [batches[i % n_batches] for i in range(n_steps)]


def test_production_trajectory_matches_jax():
    hj = jconfig.parse_args(jconfig.get_opts(), FLAGS)
    ht = tconfig.parse_args(tconfig.get_opts(), FLAGS)
    assert json.dumps(vars(hj), sort_keys=True, default=str) == \
        json.dumps(vars(ht), sort_keys=True, default=str)
    assert hj.model["layers"]["0"]["num"] == 7 and hj.appearance_dim == 48

    jm = jmu.get_nerf(hj, 4)
    jstate = jtrainer.create_train_state(jax.random.PRNGKey(0), hj, jm, None)
    tm = tmu.get_nerf(ht, 4, device="cpu")
    bridge.load_jax_state(tm, None, jax.tree_util.tree_map(np.asarray,
                                                           jstate.params))
    tstate = ttrainer.create_train_state(ht, tm, None, device="cpu")
    jstep = jax.jit(jtrainer.make_train_step(
        jm, None, hj, jtrainer.render_config_from_hparams(hj),
        jtrainer.SceneInfo()))
    tstep = ttrainer.make_train_step(
        ht, ttrainer.render_config_from_hparams(ht), ttrainer.SceneInfo(),
        device="cpu")

    got, want = [], []
    for batch in make_batches(STEPS):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tstate, tmet = tstep(tstate, batch)
        assert float(tmet["finite"]) == 1.0
        want.append(float(jmet["all_loss"]))
        got.append(float(tmet["all_loss"]))
    got, want = np.asarray(got), np.asarray(want)
    rel = np.abs(got - want) / (np.abs(want) + 1e-9)
    print(f"production trajectory: rel {rel}")
    assert rel[:2].max() < 5e-4, rel
    assert rel[:3].max() < 5e-3, rel
    assert np.median(rel) < 8e-2, rel
    assert tstate.step == int(jstate.step) == STEPS
