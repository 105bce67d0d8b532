"""Top-2 routing with the load-importance loss over a model chunk that
spans ranks, in the port on the CPU (2 gloo processes,
tests/torch_parallel_worker.py) against JAX's one-process
``Runner.train``.

At the tiny Building config (4 experts) with the published routing
(capacity factor 1.0, batch-prioritized routing, l_aux weight 5e-4), k: 2,
--gate_noise 1.0 with --use_load_importance_loss and
--compute_balance_loss, from one JAX step-0 checkpoint, 3 steps of a
64-ray global batch: the 2,048-point model chunk is the global 256
points, so it spans both ranks. Each rank routes the whole chunk (K
experts and the top gate a token exchanged), and sums the loss's
per-expert importance and load over the holders differentiably
(``ChunkShare.sum``). The gate noise draws are zeros on both sides (the
port's ``MoELayer.noise`` in the worker, a stand-in for
``jax.random.normal`` here), so the loss keeps its noise scale and the
two packages draw alike. The ranks agree, and every leaf of the step-3
checkpoint is within 1e-5 of JAX's (Adam moments of max(1, the leaf)).
"""
import jax
import jax.numpy as jnp
import pytest

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import native
from switch_nerf_tpu import runner as jrunner
from switch_nerf_tpu.models import model_utils as jmu
from tests.test_torch_parallel import (assert_ranks_equal, assert_within,
                                       published, read_step)
from tests.torch_port_helpers import (Ranks, jax_train_state, make_mega_scene,
                                      mega_train_hparams)
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401

STEPS = 3


def hparams(scene, exp):
    h = published(mega_train_hparams(scene, exp, "memory"))
    h.model["layers"]["0"]["k"] = 2
    h.gate_noise = 1.0
    h.use_load_importance_loss = h.compute_balance_loss = True
    h.train_iterations = STEPS
    return h


def test_load_importance_over_a_shared_chunk_matches_jax(tmp_path):
    scene = make_mega_scene(tmp_path / "scene")
    h = hparams(scene, "unused")
    jckpt.save_checkpoint(tmp_path / "ckpt0", jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, 5), jmu.get_bg_nerf(h, 5)))
    ckpt = str(tmp_path / "ckpt0" / "0")
    ht = hparams(scene, tmp_path / "port")
    ht.ckpt_path = ckpt
    ranks = Ranks(tmp_path / "job.pkl", [
        {"name": "li", "kind": "train", "quiet_noise": True, "h": ht}])
    hj = hparams(scene, tmp_path / "jax")
    hj.ckpt_path = ckpt
    with pytest.MonkeyPatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        m.setattr(jax.random, "normal",
                  lambda key, shape, dtype=jnp.float32: jnp.zeros(shape,
                                                                  dtype))
        jrunner.Runner(hj).train()
    outs = ranks.get("li")
    assert_ranks_equal(outs)
    assert all(o["step"] == STEPS for o in outs)
    got, _ = read_step(tmp_path / "port" / "0" / "models", STEPS)
    want, _ = read_step(tmp_path / "jax" / "0" / "models", STEPS)
    worst = assert_within(got, want, 1e-5)
    print(f"load-importance over a shared chunk: parameters within "
          f"{worst:.2e} of JAX's")
