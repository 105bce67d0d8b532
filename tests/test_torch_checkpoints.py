"""The port's checkpoints (checkpoints.py, _msgpack.py, the train-state
bridge) vs the JAX package's, on the CPU, at the tiny Building config.

A JAX checkpoint taken after one JAX train step (non-zero Adam moments)
loads into the port, and one the port writes after a port train step
loads into the JAX package's load_checkpoint with create_train_state's
template, with and without gradient accumulation and the LR schedule.
Equality is exact: the trees hold the same float32 bytes, and the port's
state.msgpack is byte-for-byte what flax writes for the tree JAX restores.
"""
import copy
import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import trainer as jtrainer
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import _msgpack, bridge
from switch_nerf_torch import checkpoints as tckpt
from switch_nerf_torch import trainer as ttrainer
from switch_nerf_torch.models import model_utils as tmu
from tests.torch_port_helpers import (jax_train_state, ray_batch,
                                      tiny_building_hparams, to_jax)

SCENE = (np.zeros(3, np.float32), np.ones(3, np.float32))
LAYOUTS = {"adam": (1, False), "multisteps": (2, False),
           "constant_lr": (1, True)}


def hparams(acc, no_sched):
    h = tiny_building_hparams()
    h.moe_train_batch = True
    h.perturb = 0.0
    h.use_sigma_noise = False
    h.train_iterations = 100
    h.accumulation_steps = acc
    h.no_optimizer_schedulers = no_sched
    return h


def batch(seed, n=128):
    b = ray_batch(n, seed=seed)
    b["rgbs"] = np.random.default_rng(50 + seed).uniform(
        size=(n, 3)).astype(np.float32)
    return b


def host_tree(state):
    return jax.device_get(jckpt._state_tree(state))


def flat(tree):
    """{keystr: numpy leaf} of a state tree."""
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(
                serialization.to_state_dict(tree))}


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def port_state(h):
    model = tmu.get_nerf(h, 8, device="cpu", seed=3)
    bg = tmu.get_bg_nerf(h, 8, device="cpu", seed=4)
    return ttrainer.create_train_state(h, model, bg, device="cpu")


@pytest.fixture(scope="module", params=list(LAYOUTS))
def jax_stepped(request, tmp_path_factory):
    """A JAX checkpoint after one train step (acc 2: after two micro-steps,
    so the first window has been applied, then a third in the window)."""
    acc, no_sched = LAYOUTS[request.param]
    h = hparams(acc, no_sched)
    jm, jbg = jmu.get_nerf(h, 8), jmu.get_bg_nerf(h, 8)
    state = jax_train_state(jax.random.PRNGKey(0), h, jm, jbg)
    step = jax.jit(jtrainer.make_train_step(
        jm, jbg, h, jtrainer.render_config_from_hparams(h),
        jtrainer.SceneInfo(*map(jnp.asarray, SCENE))))
    for i in range(2 * acc - 1):
        state, _ = step(state, to_jax(batch(i)))
    root = tmp_path_factory.mktemp(f"jax_{request.param}")
    jckpt.save_checkpoint(root, state, dataset_state="3", dataset_index=2)
    return h, jm, jbg, state, root, step


def test_codec_decodes_flax_bytes_as_msgpack(jax_stepped):
    *_, state, root, _ = jax_stepped
    data = (jckpt.latest_checkpoint(root) / "state.msgpack").read_bytes()
    ours = _msgpack.unpackb(data)
    ref = msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack,
                          raw=False)
    assert_trees_equal(ours, ref)
    assert_trees_equal(ours, host_tree(state))
    assert _msgpack.packb(ours) == data


@pytest.mark.parametrize("obj", [
    0, 127, 128, 65536, 2 ** 40, -1, -33, -129, -2 ** 40, 1.5, "a" * 31,
    "b" * 300, b"x" * 70000, None, True, list(range(17)),
    {str(i): i for i in range(17)}, np.float32(2.5), np.int32(-7),
    np.arange(6, dtype=np.uint8).reshape(2, 3)],
    ids=lambda o: type(o).__name__)
def test_codec_scalars_match_msgpack(obj):
    ref = msgpack.packb(obj, default=serialization._msgpack_ext_pack,
                        use_bin_type=True)
    assert _msgpack.packb(obj) == ref
    back = _msgpack.unpackb(ref)
    want = serialization.msgpack_restore(ref)
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(back, want)
        assert back.dtype == want.dtype
    else:
        assert back == want and type(back) is type(want)


def test_codec_bfloat16_round_trip():
    arr = np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3)
    data = serialization.msgpack_serialize({"w": arr})
    t = _msgpack.unpackb(data)["w"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (2, 3)
    np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))
    assert _msgpack.packb({"w": t}) == data


def test_jax_checkpoint_loads_into_port(jax_stepped):
    h, _, _, jstate, root, _ = jax_stepped
    ts = port_state(h)
    ts, extra = tckpt.load_checkpoint(root, ts, restore_rng_states=False)
    assert extra["dataset_state"] == "3" and extra["dataset_index"] == 2
    assert ts.step == int(jstate.step)
    np.testing.assert_array_equal(ts.rng, np.asarray(jstate.rng))
    # parameters, Adam's moments and counts, the MultiSteps window
    assert_trees_equal(bridge.export_jax_train_state(ts, ts.rng),
                       host_tree(jstate))
    assert any(float(s["exp_avg"].abs().max()) > 0
               for s in ts.optimizer.state.values())
    assert extra["param_fingerprint"] == jckpt._param_fingerprint(
        jstate.params) == tckpt._state_fingerprint(ts)


def test_port_checkpoint_loads_into_jax(jax_stepped, tmp_path):
    h, jm, jbg, jstate, root, jstep = jax_stepped
    ts = port_state(h)
    tckpt.load_checkpoint(root, ts, restore_rng_states=False)
    step = ttrainer.make_train_step(
        h, ttrainer.render_config_from_hparams(h),
        ttrainer.SceneInfo(*SCENE), device="cpu")
    ts, met = step(ts, batch(7))
    assert float(met["finite"]) == 1.0
    out = tckpt.save_checkpoint(tmp_path, ts, dataset_state="9")
    assert out == tmp_path / str(ts.step)

    template = jax_train_state(jax.random.PRNGKey(1), h, jm, jbg)
    restored, extra = jckpt.load_checkpoint(tmp_path, template)
    want = bridge.export_jax_train_state(ts, ts.rng)
    assert_trees_equal(host_tree(restored), want)
    assert extra["dataset_state"] == "9"
    assert extra["param_fingerprint"] == jckpt._param_fingerprint(
        restored.params)
    assert (out / "state.msgpack").read_bytes() == serialization.to_bytes(
        host_tree(restored))
    # the restored JAX state trains on
    _, met = jstep(restored, to_jax(batch(8)))
    assert float(met["finite"]) == 1.0


def test_save_load_round_trip_and_rng(tmp_path):
    """A fresh port state: the key written is jax.random.PRNGKey(seed)'s;
    a load restores every parameter and moment bit for bit, and the numpy
    and Python random states."""
    h = hparams(1, False)
    ts = port_state(h)
    step = ttrainer.make_train_step(
        h, ttrainer.render_config_from_hparams(h),
        ttrainer.SceneInfo(*SCENE), device="cpu")
    ts, _ = step(ts, batch(1))
    np.random.seed(5)
    want_np = np.random.get_state()[1].copy()
    tckpt.save_checkpoint(tmp_path, ts)
    np.random.seed(6)

    fresh = port_state(hparams(1, False))
    fresh.generator.manual_seed(11)
    tckpt.load_checkpoint(tmp_path / "1", fresh)
    np.testing.assert_array_equal(np.random.get_state()[1], want_np)
    np.testing.assert_array_equal(
        fresh.rng, np.asarray(jax.random.PRNGKey(h.random_seed)))
    for a, b in zip(ts.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
        sa, sb = ts.optimizer.state[a], fresh.optimizer.state[b]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k]), k
    assert (fresh.step, fresh.opt_step) == (ts.step, ts.opt_step)


def test_latest_checkpoint_keep_and_refusals(tmp_path):
    h = hparams(1, False)
    ts = port_state(h)
    for s in (1, 2, 3):
        ts.step = s
        tckpt.save_checkpoint(tmp_path, ts, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2", "3"]
    # a step dir without extra.json is an uncommitted save: skipped
    (tmp_path / "7").mkdir()
    (tmp_path / "7" / "state.msgpack").write_bytes(b"")
    assert tckpt.latest_checkpoint(tmp_path) == tmp_path / "3"
    assert tckpt.latest_checkpoint(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(tmp_path / "empty", ts)

    # a step dir whose orbax directory lacks its metadata (orbax
    # checkpoints load: tests/test_torch_orbax.py)
    (tmp_path / "8" / "orbax").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        tckpt.load_checkpoint(tmp_path / "8", ts)

    other = copy.copy(h)
    other.appearance_dim = 4
    other.model = copy.deepcopy(h.model)
    other.model["layers"]["2"]["in_ch"] -= 4
    with pytest.raises(ValueError, match="different model architecture"):
        tckpt.load_checkpoint(tmp_path, port_state(other))
    with pytest.raises(ValueError, match="accumulation"):
        tckpt.load_checkpoint(tmp_path, port_state(hparams(2, False)))
    with pytest.raises(ValueError, match="schedule"):
        tckpt.load_checkpoint(tmp_path, port_state(hparams(1, True)))
    extra = json.loads((tmp_path / "3" / "extra.json").read_text())
    assert extra["iteration"] == extra["host_iteration"] == 3
