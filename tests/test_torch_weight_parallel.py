"""Expert weight parallelism and ZeRO-1 in the port
(--expert_weight_parallel, --shard_optimizer_states) on the CPU, in real
gloo process groups (tests/torch_parallel_worker.py), against the port's
data-parallel run and JAX's ``Runner.train`` under both flags on the
virtual (8, 1) and (4, 2) meshes.

On the 24x16 synthetic scene at the tiny Building config (4 experts,
width 16), from one JAX step-0 checkpoint, with the published routing
(capacity factor 1.0, batch-prioritized routing, l_aux weight 5e-4), 3
steps of a 64-ray global batch:

  * on 2 ranks (mesh (2, 1)): weight parallelism, ZeRO-1 and both; on 4
    (mesh (2, 2)): expert parallelism with both. The step-3 checkpoint is
    the data-parallel run's on as many ranks, byte for byte on 2 ranks
    (two gradients sum alike in any order, and Adam on a slice is Adam on
    the whole) and within 1e-6 of each leaf's largest entry on 4; within
    1e-5 of JAX's; the same tokens dropped; one weight gather and one
    reduce-scatter a step. JAX's runs carry both flags, as the layouts
    leave its numbers alone (``tests/test_trainer.py`` pins each flag);
  * every rank's parts of the parameters and Adam's moments are, leaf by
    leaf, what JAX's device (d, e) holds under the same flags: the shapes
    of its ``devices_indices_map`` slices and the values of the
    checkpoint's leaves there (the odd-sized leaves stay whole);
  * checkpoints: a run resumed from the other layout's step-3 checkpoint,
    with no step left, saves it again byte for byte, both ways;
  * no-drop training with both flags saves the data-parallel run's
    checkpoint byte for byte;
  * eval_image with both flags (the experts' columns gathered once) gives
    the data-parallel run's metrics byte for byte;
  * the weight gather's autograd in float64 on (2, 1) and (2, 2);
  * ``parallel/mesh.leaf_spec`` is JAX's rule on every leaf of the train
    state, on meshes up to 8 devices (3 rows: the experts' 16 columns do
    not divide, so they stay whole).
"""
import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import native
from switch_nerf_tpu import runner as jrunner
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_tpu.parallel import mesh as jmesh
from switch_nerf_torch import _msgpack, bridge
from switch_nerf_torch.parallel.mesh import Mesh, leaf_spec
from tests.test_torch_parallel import (assert_within, published, read_step,
                                       same)
from tests.torch_port_helpers import (Ranks, jax_train_state, mega_hparams,
                                      mega_train_hparams, with_val_image)
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401

STEPS = 3
# name: (mesh, expert parallel, weight parallel, ZeRO-1), its data-parallel
# twin and JAX's run
LAYOUTS = {"ewp": ((2, 1), False, True, False),
           "zero": ((2, 1), False, False, True),
           "both": ((2, 1), False, True, True),
           "ep_both": ((2, 2), True, True, True)}
TWIN = {"ewp": ("dp", "jax81"), "zero": ("dp", "jax81"),
        "both": ("dp", "jax81"), "ep_both": ("dp4", "jax42")}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return with_val_image(tmp_path_factory.mktemp("mega"))


def jax_state(h):
    return jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, 6), jmu.get_bg_nerf(h, 6))


@pytest.fixture(scope="module")
def jax_step0(scene):
    """The scene's JAX train state at step 0 and its hparams."""
    h = mega_train_hparams(scene, "unused", "memory")
    return jax_state(h), h


@pytest.fixture(scope="module")
def jax_checkpoint(jax_step0, tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt0")
    jckpt.save_checkpoint(root, jax_step0[0])
    return root / "0"


def flags(h, mesh, ep, wp, zero):
    h.mesh_shape = list(mesh)
    h.no_expert_parallel = not ep
    h.expert_weight_parallel = wp
    h.shard_optimizer_states = zero
    return h


@pytest.fixture(scope="module")
def jobs(scene, jax_checkpoint, tmp_path_factory):
    """The 2-rank and 4-rank scenarios, started at once; JAX's
    Runner.train with both flags runs meanwhile on (8, 1) and (4, 2)."""
    tmp = tmp_path_factory.mktemp("wp")

    def hp(name, layout=None, ckpt=jax_checkpoint, **over):
        h = published(mega_train_hparams(scene, tmp / name, "memory"))
        h.ckpt_path, h.train_iterations = str(ckpt), STEPS
        for k, v in over.items():
            setattr(h, k, v)
        return flags(h, *LAYOUTS[layout]) if layout else h

    def models(name):
        return tmp / name / "0" / "models" / str(STEPS)

    def ev(name, layout=None):
        h = mega_hparams(scene, tmp / name)
        h.ckpt_path = str(jax_checkpoint)
        return flags(h, *LAYOUTS[layout]) if layout else h

    train = {"kind": "train", "drops": True, "layout": True}
    two = [{"name": "dp", **train, "h": hp("dp")}]
    two += [{"name": n, **train, "h": hp(n, n)}
            for n in ("ewp", "zero", "both")]
    two += [
        {"name": "both_from_dp", "kind": "train",
         "h": hp("both_from_dp", "both", ckpt=models("dp"))},
        {"name": "dp_from_both", "kind": "train",
         "h": hp("dp_from_both", ckpt=models("both"))},
        {"name": "dp_nodrop", "kind": "train",
         "h": hp("dp_nodrop", moe_train_batch=False)},
        {"name": "both_nodrop", "kind": "train",
         "h": hp("both_nodrop", "both", moe_train_batch=False)},
        {"name": "dp_eval", "kind": "eval", "entry": "eval_image",
         "h": ev("dp_eval")},
        {"name": "both_eval", "kind": "eval", "entry": "eval_image",
         "h": ev("both_eval", "both")},
        {"name": "gather", "kind": "gather", "mesh_shape": (2, 1)}]
    four = [
        {"name": "dp4", **train, "h": hp("dp4")},
        {"name": "ep_both", **train, "h": hp("ep_both", "ep_both")},
        {"name": "ep_both_from_dp4", "kind": "train",
         "h": hp("ep_both_from_dp4", "ep_both", ckpt=models("dp4"))},
        {"name": "dp4_from_ep_both", "kind": "train",
         "h": hp("dp4_from_ep_both", ckpt=models("ep_both"))},
        {"name": "gather", "kind": "gather", "mesh_shape": (2, 2)}]
    ranks = {2: Ranks(tmp / "job2.pkl", two, world=2),
             4: Ranks(tmp / "job4.pkl", four, world=4)}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        for name, mesh, ep in (("jax81", (8, 1), False),
                               ("jax42", (4, 2), True)):
            jrunner.Runner(flags(hp(name), mesh, ep, True, True)).train()
    return ranks, tmp


def world_of(name):
    mesh = LAYOUTS[name][0]
    return mesh[0] * mesh[1]


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_trains_as_data_parallel_and_jax(name, jobs):
    ranks, tmp = jobs
    dp, jax_run = TWIN[name]
    world = world_of(name)
    outs, refs = ranks[world].get(name), ranks[world].get(dp)
    for o in outs[1:]:
        assert o["step"] == outs[0]["step"] == STEPS
        assert same(outs[0]["metrics"], o["metrics"])
    path = tmp / name / "0" / "models" / str(STEPS) / "state.msgpack"
    want = tmp / dp / "0" / "models" / str(STEPS) / "state.msgpack"
    if world == 2:
        assert same(outs[0]["metrics"], refs[0]["metrics"])
        assert path.read_bytes() == want.read_bytes()
    got, _ = read_step(tmp / name / "0" / "models", STEPS)
    w_dp = assert_within(got, read_step(tmp / dp / "0" / "models",
                                        STEPS)[0], 1e-6)
    w_jax = assert_within(got, read_step(tmp / jax_run / "0" / "models",
                                         STEPS)[0], 1e-5)
    drops = [sum(r["drops"][i] for r in outs) for i in (0, 1)]
    assert drops == [sum(r["drops"][i] for r in refs) for i in (0, 1)]
    assert 0 < drops[0] < drops[1]
    np.testing.assert_allclose([m["gate_loss"] for m in outs[0]["metrics"]],
                               [m["gate_loss"] for m in refs[0]["metrics"]],
                               rtol=1e-6)
    _, _, wp, zero = LAYOUTS[name]
    for o in outs:
        g = o["gathers"]
        assert (g["gathers"], g["reduce_scatters"]) == (
            (STEPS, STEPS) if wp else (0, 0))
        assert o["optimizer"] == ("ZeroAdam" if zero else "Adam")
    print(f"{name}: vs data parallel {w_dp:.2e}, vs JAX {w_jax:.2e} of the "
          f"leaf's largest entry; dropped {drops[0]} of {drops[1]}")


def jax_layout(state, h, mesh_shape, ep, wp, zero):
    """JAX's shardings of the params and Adam's moments of the train
    state under the flags, by flat path, and its mesh."""
    d, e = mesh_shape
    mesh = jmesh.create_mesh(mesh_shape, devices=jax.devices()[:d * e])
    n = h.moe_expert_num
    params = jmesh.param_shardings(state.params, mesh, n, ep, wp)
    opt = jmesh.opt_state_shardings(state.opt_state, mesh, n, ep, wp,
                                    zero_data_axis=zero)

    def flat(tree):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        return {tuple(str(k.key) for k in kp): s for kp, s in leaves}
    return mesh, {"params": flat(params), "mu": flat(opt[0].mu),
                  "nu": flat(opt[0].nu)}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_rank_layout_is_jax_addressable_shards(name, jobs, jax_step0):
    """Per rank and leaf, the port's parts of the parameters and moments
    have the shape of JAX's shard on device (d, e) and hold the
    checkpoint's values at that shard's index."""
    ranks, tmp = jobs
    mesh_shape, ep, wp, zero = LAYOUTS[name]
    mesh, shardings = jax_layout(*jax_step0, mesh_shape, ep, wp, zero)
    whole, _ = read_step(tmp / name / "0" / "models", STEPS)
    prefix = {"params": ("params",), "mu": ("opt_state", "0", "mu"),
              "nu": ("opt_state", "0", "nu")}
    cut = {"params": 0, "mu": 0, "nu": 0}
    for r, out in enumerate(ranks[world_of(name)].get(name)):
        device = mesh.devices[r // mesh_shape[1], r % mesh_shape[1]]
        for kind, leaves in out["local"].items():
            assert sorted(leaves) == sorted(shardings[kind])
            for path, local in leaves.items():
                arr = whole[prefix[kind] + path]
                index = shardings[kind][path].devices_indices_map(
                    arr.shape)[device]
                assert local.shape == arr[index].shape, (kind, path)
                np.testing.assert_array_equal(local, arr[index])
                cut[kind] += local.size < arr.size
    # some leaves cut, the odd-sized ones whole
    assert cut["params"] > 0 if wp or ep else cut["params"] == 0
    assert cut["mu"] > cut["params"] if zero else cut["mu"] == cut["params"]
    kernel = out["local"]["mu"][("nerf", "layer_xyz", "fc0", "kernel")]
    assert kernel.shape == (15, 16)


@pytest.mark.parametrize("direction", ["dp_to_both", "both_to_dp",
                                       "dp4_to_ep_both", "ep_both_to_dp4"])
def test_resume_across_layouts_is_exact(direction, jobs):
    """A run resumed from the other layout's step-3 checkpoint, with no
    step left, saves that checkpoint again byte for byte."""
    ranks, tmp = jobs
    source, target = direction.split("_to_")
    name = f"{target}_from_{source}"
    outs = ranks[4 if "4" in direction else 2].get(name)
    assert all(o["step"] == STEPS and not o["metrics"] for o in outs)
    saved = tmp / name / "0" / "models" / str(STEPS) / "state.msgpack"
    source = tmp / source / "0" / "models" / str(STEPS) / "state.msgpack"
    assert saved.read_bytes() == source.read_bytes()


def test_nodrop_training_equals_data_parallel(jobs):
    """No-drop training (the ragged chain K1R/K2R on the pass's gathered
    columns) with both flags saves the data-parallel run's checkpoint."""
    ranks, tmp = jobs
    outs, refs = ranks[2].get("both_nodrop"), ranks[2].get("dp_nodrop")
    assert all(o["step"] == STEPS for o in outs)
    assert same(outs[0]["metrics"], refs[0]["metrics"])
    assert ((tmp / "both_nodrop" / "0" / "models" / str(STEPS)
             / "state.msgpack").read_bytes()
            == (tmp / "dp_nodrop" / "0" / "models" / str(STEPS)
                / "state.msgpack").read_bytes())


def test_eval_equals_data_parallel(jobs):
    ranks, tmp = jobs
    got, want = ranks[2].get("both_eval"), ranks[2].get("dp_eval")
    for a, b in zip(got, want):
        assert ({k: v for k, v in a["means"].items() if k != "time"}
                == {k: v for k, v in b["means"].items() if k != "time"})
    files = [sorted(str(p.relative_to(d)) for p in d.rglob("*.txt"))
             for d in (tmp / "both_eval" / "0", tmp / "dp_eval" / "0")]
    assert files[0] == files[1] and files[0]


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_gather_autograd_float64(mesh, jobs):
    ranks, _ = jobs
    d, e = (int(x) for x in mesh.split("x"))
    for r, o in enumerate(ranks[d * e].get("gather")):
        assert o["y"] == 0.0 and o["dw"] < 1e-12, o
        e_loc = 4 // e
        assert o["shapes"] == [[e_loc, 6, 4], [e_loc, 1, 4], [e_loc, 5, 2]]
        assert o["whole"] == [[e_loc, 6, 8], [e_loc, 1, 8], [e_loc, 5, 4]]
        assert o["form"] == "gloo_cpu"
        assert o["data"] == [i * e + r % e for i in range(d)]


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2), (2, 2), (4, 2),
                                        (3, 1), (8, 1)])
def test_leaf_spec_is_jax_rule(mesh_shape, jax_step0):
    """``leaf_spec`` against JAX's param_shardings / opt_state_shardings
    for every flag combination, on every leaf of the train state."""
    state, h = jax_step0
    n = h.moe_expert_num
    checked = 0
    for ep in (False, True):
        for wp in (False, True):
            for zero in (False, True):
                mesh, shardings = jax_layout(state, h, mesh_shape, ep, wp,
                                             zero)
                for kind, leaves in shardings.items():
                    tree = (state.params if kind == "params"
                            else getattr(state.opt_state[0], kind))
                    flat = {tuple(str(k.key) for k in kp): v for kp, v in
                            jax.tree_util.tree_flatten_with_path(tree)[0]}
                    for path, s in leaves.items():
                        got = leaf_spec(path, flat[path].shape, n,
                                        expert_parallel=ep,
                                        weight_parallel=wp,
                                        data=mesh_shape[0], zero=zero,
                                        moment=kind != "params")
                        want = tuple(s.spec)
                        assert got == want, (kind, path, got, want)
                        checked += 1
    assert checked > 0


def test_local_tree_is_jax_shards(jax_checkpoint):
    """``bridge.local_tree`` cuts a train-state tree as JAX's shardings
    place it on device (d, e), EP + EWP + ZeRO-1 on (2, 2)."""
    tree = _msgpack.unpackb((jax_checkpoint / "state.msgpack").read_bytes())
    params = tree["params"]
    for r in range(4):
        mesh = Mesh(2, 2, r, None, None, None, expert_parallel=True,
                    weight_parallel=True, zero=True)
        part = bridge.local_tree(tree, mesh, 4)
        w0 = params["nerf"]["layer_0"]["experts"]["w0"]
        e, d = r % 2, r // 2
        np.testing.assert_array_equal(
            part["params"]["nerf"]["layer_0"]["experts"]["w0"],
            w0[2 * e:2 * e + 2, :, 8 * d:8 * d + 8])
        mu = part["opt_state"]["0"]["mu"]["nerf"]
        assert mu["layer_1"]["fc0"]["kernel"].shape == (8, 16)
        assert mu["layer_xyz"]["fc0"]["kernel"].shape == (15, 16)
        assert part["params"]["nerf"]["layer_1"]["fc0"]["kernel"].shape \
            == (16, 16)


@pytest.mark.parametrize("foreach", [False, True])
def test_adam_on_a_slice_is_adam_on_the_whole(foreach):
    """ZeRO-1's premise: Adam (torch.optim.Adam, per-tensor or foreach
    kernels) on a slice of a leaf, with the slice's own moments, gives the
    whole leaf's update there bit for bit, and the two kernels agree."""
    import torch

    shapes = [(16, 15), (256, 331), (8, 256, 256), (1, 256)]

    def half(t):
        return t[:, :t.shape[1] // 2] if t.dim() == 2 else t[:t.shape[0] // 2]

    def run(kernel_foreach, sliced):
        def draw(seed, shape):
            t = torch.randn(shape, generator=torch.Generator().manual_seed(
                seed))
            return half(t).contiguous() if sliced else t
        ps = [draw(i, s).requires_grad_() for i, s in enumerate(shapes)]
        opt = torch.optim.Adam(ps, lr=5e-4, foreach=kernel_foreach)
        for step in range(4):
            for i, p in enumerate(ps):
                p.grad = draw(100 * step + i + 10, shapes[i])
            opt.step()
        return [half(p.detach()) if not sliced else p.detach() for p in ps]
    whole, sliced = run(foreach, False), run(foreach, True)
    assert all(torch.equal(a, b) for a, b in zip(whole, sliced))
    other = run(not foreach, True)
    assert all(torch.equal(a, b) for a, b in zip(sliced, other))
