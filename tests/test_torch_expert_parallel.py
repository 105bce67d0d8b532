"""Expert parallelism in the port (--expert_parallel --mesh_shape D E) on
the CPU, in real gloo process groups (tests/torch_parallel_worker.py),
against the port's data-parallel run and JAX's expert-parallel
``Runner.train`` on a (4, 2) mesh of the 8 virtual CPU devices.

On the 24x16 synthetic scene at the tiny Building config (4 experts), from
one JAX step-0 checkpoint, with the published routing (capacity factor
1.0, batch-prioritized routing, l_aux weight 5e-4), 3 steps of a 64-ray
global batch:

  * meshes (1, 2) on 2 ranks and (2, 2) on 4: the step-3 checkpoint
    within 1e-6 of each leaf's largest entry of the data-parallel run's on
    as many ranks and within 1e-5 of JAX's, the same tokens dropped,
    gate_loss within 1e-6 relative. The tiny config's 2,048-point model
    chunk is the global 256 points, so it spans every rank: each holder's
    dispatch buffer carries zero rows for the slots it does not hold;
  * 96-point chunks, where a chunk spanning both ranks is another call
    of each rank's pass: every rank raises before its first step;
  * no-drop training (the whole model gathered at each call, its
    gradients reduced to the owners) against data parallelism;
  * checkpoints: the expert-parallel save of a state loaded from a
    data-parallel checkpoint is that checkpoint byte for byte, and the
    other way round (resumes across the layouts are exact);
  * eval_image under expert parallelism (the experts gathered once) gives
    the data-parallel run's metrics byte for byte;
  * the token exchange's autograd in float64 against a dense reference,
    each rank's capacity its own, on (1, 2) and (2, 2);
  * a rank that makes one more exchange than its group raises on every
    rank instead of hanging;
  * ``bridge.local_tree`` / ``whole_tree`` cut and join a JAX tree.
"""
import jax
import numpy as np
import pytest

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import native
from switch_nerf_tpu import runner as jrunner
from switch_nerf_tpu import trainer as jtrainer
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import _msgpack, bridge
from tests.test_torch_parallel import (assert_within, published, read_step,
                                       same)
from tests.torch_port_helpers import (Ranks, mega_hparams, mega_train_hparams,
                                      with_val_image)

STEPS = 3
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return with_val_image(tmp_path_factory.mktemp("mega"))


@pytest.fixture(scope="module")
def jax_checkpoint(scene, tmp_path_factory):
    h = mega_train_hparams(scene, "unused", "memory")
    state = jtrainer.create_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, 6), jmu.get_bg_nerf(h, 6))
    root = tmp_path_factory.mktemp("ckpt0")
    jckpt.save_checkpoint(root, state)
    return root / "0"


def expert_parallel(h, d, e):
    h.no_expert_parallel = False
    h.mesh_shape = [d, e]
    return h


@pytest.fixture(scope="module")
def jobs(scene, jax_checkpoint, tmp_path_factory):
    """The 2-rank and 4-rank scenarios, started at once; JAX's
    expert-parallel Runner.train runs meanwhile."""
    tmp = tmp_path_factory.mktemp("ep")

    def hp(name, mesh=None, ckpt=jax_checkpoint, **over):
        h = published(mega_train_hparams(scene, tmp / name, "memory"))
        h.ckpt_path, h.train_iterations = str(ckpt), STEPS
        for k, v in over.items():
            setattr(h, k, v)
        return expert_parallel(h, *mesh) if mesh else h

    def models(name):
        return tmp / name / "0" / "models" / str(STEPS)

    def ev(name, mesh=None):
        h = mega_hparams(scene, tmp / name)
        h.ckpt_path = str(jax_checkpoint)
        return expert_parallel(h, *mesh) if mesh else h

    train = {"kind": "train", "drops": True}
    two = [
        {"name": "dp", **train, "h": hp("dp")},
        {"name": "ep", **train, "h": hp("ep", (1, 2))},
        {"name": "ep_mixed", "kind": "train", "refused": True,
         "h": hp("ep_mixed", (1, 2), model_chunk_size=96)},
        {"name": "dp_nodrop", **train,
         "h": hp("dp_nodrop", moe_train_batch=False)},
        {"name": "ep_nodrop", **train,
         "h": hp("ep_nodrop", (1, 2), moe_train_batch=False)},
        {"name": "ep_from_dp", "kind": "train",
         "h": hp("ep_from_dp", (1, 2), ckpt=models("dp"))},
        {"name": "dp_from_ep", "kind": "train",
         "h": hp("dp_from_ep", ckpt=models("ep"))},
        {"name": "dp_eval", "kind": "eval", "entry": "eval_image",
         "h": ev("dp_eval")},
        {"name": "ep_eval", "kind": "eval", "entry": "eval_image",
         "h": ev("ep_eval", (1, 2))},
        {"name": "exchange", "kind": "exchange", "mesh_shape": (1, 2)},
        {"name": "lockstep", "kind": "lockstep"},
    ]
    four = [
        {"name": "dp4", **train, "h": hp("dp4")},
        {"name": "ep22", **train, "h": hp("ep22", (2, 2))},
        {"name": "exchange", "kind": "exchange", "mesh_shape": (2, 2)},
    ]
    ranks = {2: Ranks(tmp / "job2.pkl", two, world=2),
             4: Ranks(tmp / "job4.pkl", four, world=4)}
    hj = expert_parallel(hp("jax"), 4, 2)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        jrunner.Runner(hj).train()
    return ranks, tmp


def assert_ranks_agree(outs):
    for b in outs[1:]:
        assert b["step"] == outs[0]["step"] == STEPS
        assert same(outs[0]["metrics"], b["metrics"])


def compare(tmp, name, ref, outs, refs, rel):
    """The run's step-STEPS checkpoint within rel of the reference's;
    the same tokens dropped; gate_loss within 1e-6 relative."""
    got, _ = read_step(tmp / name / "0" / "models", STEPS)
    want, _ = read_step(tmp / ref / "0" / "models", STEPS)
    worst = assert_within(got, want, rel)
    drops = [sum(r["drops"][i] for r in outs) for i in (0, 1)]
    assert drops == [sum(r["drops"][i] for r in refs) for i in (0, 1)]
    if "gate_loss" in outs[0]["metrics"][0]:
        np.testing.assert_allclose(
            [m["gate_loss"] for m in outs[0]["metrics"]],
            [m["gate_loss"] for m in refs[0]["metrics"]], rtol=1e-6)
    return worst, drops


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_trains_as_data_parallel_and_jax(mesh, jobs):
    ranks, tmp = jobs
    world = MESHES[mesh][0] * MESHES[mesh][1]
    name, ref = ("ep", "dp") if world == 2 else ("ep22", "dp4")
    outs, refs = ranks[world].get(name), ranks[world].get(ref)
    assert_ranks_agree(outs)
    assert all(np.isfinite(v) for m in outs[0]["metrics"] for v in m.values())
    w_dp, drops = compare(tmp, name, ref, outs, refs, 1e-6)
    got, _ = read_step(tmp / name / "0" / "models", STEPS)
    want, _ = read_step(tmp / "jax" / "0" / "models", STEPS)
    w_jax = assert_within(got, want, 1e-5)
    assert 0 < drops[0] < drops[1]
    print(f"mesh {mesh}: vs data parallel {w_dp:.2e}, vs JAX (4, 2) "
          f"{w_jax:.2e} of the leaf's largest entry; dropped {drops[0]} of "
          f"{drops[1]}")


def test_chunks_out_of_lockstep_raise_on_every_rank(jobs):
    """96-point chunks on a first pass of 64 points a rank: [0, 96) spans
    rank 0's points and the start of rank 1's, whose second call is
    [96, 128). The ranks would make 1 and 2 exchanges, so every rank
    refuses the pass before its first step (no hang)."""
    ranks, _ = jobs
    for o in ranks[2].get("ep_mixed"):
        assert "expert parallelism" in o["raised"] and o["steps"] == 0
        assert "[1, 2] model calls" in o["raised"]


def test_nodrop_training(jobs):
    ranks, tmp = jobs
    outs, refs = ranks[2].get("ep_nodrop"), ranks[2].get("dp_nodrop")
    assert_ranks_agree(outs)
    compare(tmp, "ep_nodrop", "dp_nodrop", outs, refs, 1e-6)


@pytest.mark.parametrize("direction", ["dp_to_ep", "ep_to_dp"])
def test_resume_across_layouts_is_exact(direction, jobs):
    """A run resumed from the other layout's step-3 checkpoint, with no
    step left, saves that checkpoint again byte for byte."""
    ranks, tmp = jobs
    name, source = (("ep_from_dp", "dp") if direction == "dp_to_ep"
                    else ("dp_from_ep", "ep"))
    outs = ranks[2].get(name)
    assert all(o["step"] == STEPS and not o["metrics"] for o in outs)
    saved = tmp / name / "0" / "models" / str(STEPS) / "state.msgpack"
    source = tmp / source / "0" / "models" / str(STEPS) / "state.msgpack"
    assert saved.read_bytes() == source.read_bytes()


def test_eval_equals_data_parallel(jobs):
    ranks, tmp = jobs
    ep, dp = ranks[2].get("ep_eval"), ranks[2].get("dp_eval")
    for a, b in zip(ep, dp):
        got = {k: v for k, v in a["means"].items() if k != "time"}
        want = {k: v for k, v in b["means"].items() if k != "time"}
        assert got == want
    files = [sorted(str(p.relative_to(d)) for p in d.rglob("*.txt"))
             for d in (tmp / "ep_eval" / "0", tmp / "dp_eval" / "0")]
    assert files[0] == files[1] and files[0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_exchange_autograd_float64(mesh, jobs):
    ranks, _ = jobs
    d, e = MESHES[mesh]
    outs = ranks[d * e].get("exchange")
    for r, o in enumerate(outs):
        assert o["y"] < 1e-12 and o["dx"] < 1e-12 and o["dw"] < 1e-12, o
        assert o["shape"] == [4, 2 + r, 3] and o["form"] == "all_to_all"
        assert o["group"] == [r // e * e + j for j in range(e)]
        assert o["data"] == [i * e + r % e for i in range(d)]


def test_lockstep_mismatch_raises(jobs):
    ranks, _ = jobs
    for o in ranks[2].get("lockstep"):
        assert o["raised"] and "out of lockstep" in o["raised"]


def test_local_and_whole_trees(jax_checkpoint):
    tree = _msgpack.unpackb((jax_checkpoint / "state.msgpack").read_bytes())
    parts = [bridge.local_tree(tree, i, 2, 4) for i in range(2)]
    w0 = tree["params"]["nerf"]["layer_0"]["experts"]["w0"]
    for i, part in enumerate(parts):
        local = part["params"]["nerf"]["layer_0"]["experts"]["w0"]
        np.testing.assert_array_equal(local, w0[2 * i:2 * i + 2])
        mu = part["opt_state"]["0"]["mu"]["nerf"]["layer_0"]["experts"]
        assert mu["b1"].shape[0] == 2
        assert part["params"]["nerf"]["layer_xyz"]["fc0"]["kernel"].shape \
            == tree["params"]["nerf"]["layer_xyz"]["fc0"]["kernel"].shape
    whole = bridge.whole_tree(parts, 4)
    assert _msgpack.packb(whole) == _msgpack.packb(tree)
