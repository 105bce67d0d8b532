"""Data-parallel training of the port (switch_nerf_torch under torchrun, one
process per card) on the CPU, in real 2-process gloo groups
(tests/torch_parallel_worker.py), against the port in one process and the
JAX package's single-process runner.

On the 24x16 synthetic scene (4 train + 2 val images) at the tiny Building
config, every run starts from one JAX step-0 checkpoint:

  * drop-free (capacity factor = the 4 experts, l_aux weight 0, perturb 0,
    no sigma noise), 3 steps of a 64-ray global batch on the memory and on
    the filesystem dataset: the two ranks' parameters bit-equal after
    every step; the step-3 checkpoint within 1e-5 of each leaf's largest
    entry of the one-process port's and of JAX's ``Runner.train`` fed the
    same global batches (the ranks' shares, rank 0's first); counters
    equal. Measured: within 1.4e-7 of the one-process port, 7.3e-6 of JAX
    (the port's own distance from JAX, tests/test_torch_train_runner.py).
    The filesystem run writes its chunks cooperatively: the directory
    holds the arrays a single writer writes, part for part, JAX's
    FilesystemDataset reuses it, and the ranks' strided shares of a chunk
    are its rows.
  * published flags (capacity factor 1.0, batch-prioritized routing,
    l_aux weight 5e-4), 3 steps: a pass of 32 rays a rank holds 128
    points, so the tiny config's 2,048-point model chunk is the global
    256 points, half on each rank. The ranks route that chunk together,
    as JAX routes its global chunk (parallel/chunks.py): the step-3
    checkpoint within 1e-5 of each leaf's largest entry of JAX's
    ``Runner.train`` and of the one-process port fed the same global
    batches, and the ranks' dropped tokens those of one process.
    (tests/test_torch_parallel_routing.py holds chunks inside a rank and
    a mix of both.)
  * exact resume, perturb and sigma noise on (each rank its own
    generator): SIGTERM on rank 1 alone inside step 6; the ranks agree at
    step 10, save there and return; the resumed run, and one resumed from
    the uninterrupted run's step-4 interval checkpoint, repeat the
    uninterrupted run's metrics bit for bit, on every rank.
  * the finite vote: rank 1's loss terms NaN at step 2; both ranks skip
    the step (finite 0, step unchanged) and stay bit-equal.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import native
from switch_nerf_tpu import runner as jrunner
from switch_nerf_tpu.datasets import filesystem_dataset as jfs
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_torch import _msgpack
from switch_nerf_torch import runner as trunner
from switch_nerf_torch import train as ttrain
from switch_nerf_torch.datasets.block_filesystem_dataset import \
    BlockFilesystemDataset
from switch_nerf_torch.datasets.filesystem_dataset import FilesystemDataset
from switch_nerf_torch.parallel import mesh_shape
from tests.torch_port_helpers import (Ranks, block_runner_hparams, free_port,
                                      jax_train_state, make_block_test_scene,
                                      mega_train_hparams, with_val_image)
from tests.torch_parallel_worker import train as train_on_rank
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401

WORLD = 2
STEPS = 3
_ROOT = Path(__file__).parent.parent


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return with_val_image(tmp_path_factory.mktemp("mega"))


@pytest.fixture(scope="module")
def jax_checkpoint(scene, tmp_path_factory):
    """A JAX step-0 checkpoint of the scene's model (6 appearance rows)."""
    h = mega_train_hparams(scene, "unused", "memory")
    state = jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, 6), jmu.get_bg_nerf(h, 6))
    root = tmp_path_factory.mktemp("ckpt0")
    jckpt.save_checkpoint(root, state)
    return root / "0"


def drop_free(h):
    h.moe_capacity_factor = float(h.moe_expert_num)
    h.moe_l_aux_wt = 0.0
    return h


def published(h):
    h.moe_capacity_factor = 1.0
    h.batch_prioritized_routing = True
    h.moe_l_aux_wt = 5e-4
    return h


def noisy(h, **over):
    h.perturb = 1.0
    h.use_sigma_noise = True
    for k, v in over.items():
        setattr(h, k, v)
    return h


@pytest.fixture(scope="module")
def block_scene(tmp_path_factory):
    return make_block_test_scene(tmp_path_factory.mktemp("mission_bay"))


@pytest.fixture(scope="module")
def job(scene, jax_checkpoint, block_scene, tmp_path_factory):
    """The training scenarios, run once by a 2-rank job."""
    tmp = tmp_path_factory.mktemp("dp")

    def hp(name, dataset_type="memory", steps=STEPS, **over):
        h = mega_train_hparams(scene, tmp / name, dataset_type,
                               tmp / f"{name}_chunks")
        h.ckpt_path = str(jax_checkpoint)
        h.train_iterations = steps
        for k, v in over.items():
            setattr(h, k, v)
        return h

    noisy_steps = dict(steps=14, ckpt_interval=4, ckpt_keep=0)
    scenarios = [
        {"name": "memory", "kind": "train", "record": True,
         "h": drop_free(hp("memory"))},
        {"name": "filesystem", "kind": "train", "record": True,
         "h": drop_free(hp("filesystem", "filesystem"))},
        {"name": "published", "kind": "train", "drops": True,
         "record": True, "h": published(hp("published"))},
        {"name": "full", "kind": "train",
         "h": noisy(hp("full", **noisy_steps))},
        {"name": "killed", "kind": "train", "kill": (1, 6),
         "h": noisy(hp("killed", **noisy_steps))},
        {"name": "resumed", "kind": "train",
         "h": noisy(hp("resumed", **noisy_steps),
                    ckpt_path=str(tmp / "killed" / "0" / "models" / "10"))},
        {"name": "resumed4", "kind": "train",
         "h": noisy(hp("resumed4", **noisy_steps),
                    ckpt_path=str(tmp / "full" / "0" / "models" / "4"))},
        {"name": "poisoned", "kind": "train", "poison": (1, 2),
         "h": noisy(hp("poisoned", steps=4))},
        {"name": "block", "kind": "train",
         "h": block_runner_hparams(block_scene, tmp / "block",
                                   tmp / "block_chunks")},
        {"name": "meters", "kind": "meters"},
        {"name": "refusals", "kind": "refusals"},
        {"name": "cli", "kind": "train_cli", "port": free_port(),
         "h": hp("cli", steps=2)},
    ]
    return Ranks(tmp / "job.pkl", scenarios), tmp


def global_batches(ranks_out):
    """The global batch of every step: the ranks' shares, rank 0's first."""
    return [{k: np.concatenate([r["batches"][i][k] for r in ranks_out])
             for k in ranks_out[0]["batches"][i]}
            for i in range(len(ranks_out[0]["batches"]))]


def fed(monkeypatch, dataset_cls, batches):
    """dataset_cls.get_batch yields `batches` by the batch counter."""
    monkeypatch.setattr(dataset_cls, "get_batch",
                        lambda self, b, bs: dict(batches[b]))


def read_step(models, step):
    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, prefix + (k,))
        else:
            yield prefix, np.asarray(tree.float() if torch.is_tensor(tree)
                                     else tree)
    d = models / str(step)
    tree = dict(flat(_msgpack.unpackb((d / "state.msgpack").read_bytes())))
    return tree, json.loads((d / "extra.json").read_text())


def assert_within(got, want, rel):
    """Every float leaf but the JAX key within rel of the leaf's largest
    entry (Adam moments: of max(1, it)); integer leaves equal. Returns the
    worst parameter error relative to its leaf."""
    assert sorted(got) == sorted(want)
    worst = 0.0
    for path, b in want.items():
        a = got[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path == ("rng",):
            continue
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=str(path))
            continue
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        limit = rel * (scale if path[0] == "params" else max(1.0, scale))
        assert err <= limit, (path, err, scale)
        if path[0] == "params" and scale > 0:
            worst = max(worst, err / scale)
    return worst


def same(a, b) -> bool:
    """Equal metric records, NaN equal to NaN."""
    return len(a) == len(b) and all(
        x.keys() == y.keys() and np.array_equal(
            np.array(list(x.values())), np.array(list(y.values())),
            equal_nan=True) for x, y in zip(a, b))


def assert_ranks_equal(outs):
    a = outs[0]
    for b in outs[1:]:
        assert a["step"] == b["step"]
        assert all(np.array_equal(x, y) for x, y in zip(a["params"],
                                                        b["params"]))
        assert same(a["metrics"], b["metrics"])


@pytest.mark.parametrize("dataset_type", ["memory", "filesystem"])
def test_drop_free_training_matches_one_process_and_jax(
        dataset_type, job, scene, jax_checkpoint, tmp_path, monkeypatch):
    ranks, dp_tmp = job
    h1 = drop_free(mega_train_hparams(scene, tmp_path / "one", "memory"))
    hj = drop_free(mega_train_hparams(scene, tmp_path / "jax", "memory"))
    for h in (h1, hj):
        h.ckpt_path, h.train_iterations = str(jax_checkpoint), STEPS

    def references(batches):
        """The one-process runs, fed `batches` (None: the memory dataset's
        own, which the ranks share out)."""
        with monkeypatch.context() as m:
            if batches is not None:
                fed(m, trunner.MemoryDataset, batches)
            assert ttrain.main(h1, device="cpu").step == STEPS
        with monkeypatch.context() as m:
            m.setattr(native, "get_lib", lambda: None)
            if batches is not None:
                fed(m, jrunner.MemoryDataset, batches)
            jrunner.Runner(hj).train()

    if dataset_type == "memory":
        # the ranks' batches are the memory dataset's: the references run
        # while the ranks do
        seen = []
        real = trunner.Runner._put_batch
        monkeypatch.setattr(trunner.Runner, "_put_batch",
                            lambda self, b, *a: seen.append(b) or real(
                                self, b, *a))
        references(None)
        monkeypatch.undo()
    outs = ranks.get(dataset_type)
    assert_ranks_equal(outs)
    assert outs[0]["worlds"] == [WORLD] * STEPS
    assert outs[0]["step"] == STEPS
    # each rank trained on half of the global batch
    assert all(b["rays"].shape == (32, 8) for r in outs for b in r["batches"])
    batches = global_batches(outs)
    if dataset_type == "memory":
        for got, want in zip(batches, seen):
            for k, v in got.items():
                np.testing.assert_array_equal(v, want[k], err_msg=k)
    else:
        references(batches)
    dp_models = dp_tmp / dataset_type / "0" / "models"

    got, gextra = read_step(dp_models, STEPS)
    one, oextra = read_step(tmp_path / "one" / "0" / "models", STEPS)
    want, wextra = read_step(tmp_path / "jax" / "0" / "models", STEPS)
    w_one = assert_within(got, one, 1e-5)
    w_jax = assert_within(got, want, 1e-5)
    print(f"{dataset_type}: 2 ranks vs 1 process {w_one:.2e}, vs JAX "
          f"{w_jax:.2e} of the leaf's largest entry")
    for key in ("iteration", "host_iteration", "param_fingerprint"):
        assert gextra[key] == oextra[key] == wextra[key], key
    # every rank's generator state, rank 0's also under the old key
    states = gextra["torch_generator_states"]
    assert len(states) == WORLD and all(states)
    assert gextra["torch_generator_state"] == states[0]
    assert "iter 2 " in (dp_tmp / dataset_type / "0" / "log.txt").read_text()


def run_references(batches, h1, hj, monkeypatch):
    """The one-process port (its dropped tokens counted) and JAX's
    Runner.train, each fed `batches`; returns the port's record."""
    with monkeypatch.context() as m:
        fed(m, trunner.MemoryDataset, batches)
        one = train_on_rank(0, h1, drops=True)
    with monkeypatch.context() as m:
        m.setattr(native, "get_lib", lambda: None)
        fed(m, jrunner.MemoryDataset, batches)
        jrunner.Runner(hj).train()
    return one


def assert_routes_as_jax(outs, dp_exp, h1, hj, monkeypatch, what):
    """The ranks' step-STEPS checkpoint against the one-process port's and
    JAX's on the same global batches (every leaf within 1e-5 of its
    largest entry), and the ranks' dropped tokens against one process's.
    Returns (worst relative error vs JAX, drops)."""
    assert_ranks_equal(outs)
    assert all(np.isfinite(v) for m in outs[0]["metrics"] for v in m.values())
    one = run_references(global_batches(outs), h1, hj, monkeypatch)
    got, gextra = read_step(Path(dp_exp) / "0" / "models", STEPS)
    mine, _ = read_step(Path(h1.exp_name) / "0" / "models", STEPS)
    want, wextra = read_step(Path(hj.exp_name) / "0" / "models", STEPS)
    w_one = assert_within(got, mine, 1e-5)
    w_jax = assert_within(got, want, 1e-5)
    drops = [sum(r["drops"][0] for r in outs), sum(r["drops"][1]
                                                   for r in outs)]
    g2 = [m["gate_loss"] for m in outs[0]["metrics"]]
    g1 = [m["gate_loss"] for m in one["metrics"]]
    print(f"{what}: {len(outs)} ranks vs 1 process {w_one:.2e}, vs JAX "
          f"{w_jax:.2e} of the leaf's largest entry; gate_loss ranks {g2}, 1 process "
          f"{g1}; dropped {drops[0]} of {drops[1]} (1 process "
          f"{one['drops'][0]} of {one['drops'][1]})")
    assert drops == list(one["drops"])
    assert 0 < drops[0] < drops[1]
    np.testing.assert_allclose(g2, g1, rtol=1e-5)
    assert gextra["iteration"] == wextra["iteration"] == STEPS
    return w_jax, drops


def test_published_flags_route_per_rank(job, scene, jax_checkpoint, tmp_path,
                                        monkeypatch):
    """Named for the per-rank routing it once recorded; now the published
    flags with a chunk that spans both ranks (module docstring) train what
    JAX's Runner.train trains."""
    ranks, dp_tmp = job
    outs = ranks.get("published")
    h1 = published(mega_train_hparams(scene, tmp_path / "one", "memory"))
    hj = published(mega_train_hparams(scene, tmp_path / "jax", "memory"))
    for h in (h1, hj):
        h.ckpt_path, h.train_iterations = str(jax_checkpoint), STEPS
    assert_routes_as_jax(outs, dp_tmp / "published", h1, hj, monkeypatch,
                         "one spanning chunk")


def test_exact_resume_with_sigterm_on_one_rank(job):
    ranks, dp_tmp = job
    full, killed, resumed, resumed4 = (ranks.get(n) for n in (
        "full", "killed", "resumed", "resumed4"))
    for outs in (full, killed, resumed, resumed4):
        assert_ranks_equal(outs)
    # the two ranks drew different noise: their generators differ
    assert not np.array_equal(full[0]["generator"], full[1]["generator"])
    assert killed[0]["step"] == 10 and killed[1]["step"] == 10
    assert sorted(p.name for p in (dp_tmp / "killed" / "0" / "models")
                  .iterdir()) == ["10", "4", "8"]
    want = full[0]["metrics"]
    assert killed[0]["metrics"] == want[:10]
    assert resumed[0]["metrics"] == want[10:]
    assert resumed4[0]["metrics"] == want[4:]
    for r in range(WORLD):
        assert np.array_equal(resumed[r]["generator"], full[r]["generator"])
        assert all(np.array_equal(x, y) for x, y in
                   zip(resumed[r]["params"], full[r]["params"]))


def test_finite_vote_skips_on_every_rank(job):
    ranks, _ = job
    outs = ranks.get("poisoned")
    assert_ranks_equal(outs)
    m = outs[0]["metrics"]
    assert [x["finite"] for x in m] == [1.0, 0.0, 1.0, 1.0]
    assert [x["step"] for x in m] == [1, 1, 2, 3]
    assert np.isnan(m[1]["photo_loss"]) and np.isnan(m[1]["psnr"])


def chunk_arrays(root: Path):
    out = {}
    for part in sorted(root.glob("chunk_*/part_*.npz")):
        with np.load(part) as z:
            out[str(part.relative_to(root))] = {k: z[k] for k in z.files}
    return out


def assert_same_chunks(a: Path, b: Path):
    assert (a / "manifest.json").read_bytes() == \
        (b / "manifest.json").read_bytes()
    assert sorted(p.name for p in a.iterdir()) == \
        sorted(p.name for p in b.iterdir())
    ga, gb = chunk_arrays(a), chunk_arrays(b)
    assert sorted(ga) == sorted(gb) and ga
    for part in ga:
        assert sorted(ga[part]) == sorted(gb[part])
        for k in ga[part]:
            x, y = ga[part][k], gb[part][k]
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                (part, k)


def dataset(h, root, chunks, **kw):
    r = trunner.Runner(h, set_experiment_path=False, device="cpu")
    return FilesystemDataset(
        r.train_items, r.near, r.far, r.ray_altitude_range, h.center_pixels,
        [chunks], h.num_chunks, h.train_scale_factor, h.disk_flush_size,
        h.shuffle_chunk, seed=h.random_seed, **kw)


def test_cooperative_chunk_write(job, scene, tmp_path):
    """The 2-rank run's chunks hold a single writer's arrays part for part
    (the npz headers carry their write time); JAX's FilesystemDataset
    reuses the directory; the ranks' strided shares of a chunk are its
    rows."""
    ranks, dp_tmp = job
    ranks.get("filesystem")
    coop = dp_tmp / "filesystem_chunks"
    h = mega_train_hparams(scene, "unused", "filesystem", tmp_path / "one")
    single = dataset(h, scene, tmp_path / "one")
    single.close()
    assert_same_chunks(coop, tmp_path / "one")
    jr = jrunner.Runner(h, set_experiment_path=False)
    jd = jfs.FilesystemDataset(
        jr.train_items, jr.near, jr.far, jr.ray_altitude_range,
        h.center_pixels, [coop], h.num_chunks, h.train_scale_factor,
        h.disk_flush_size, h.shuffle_chunk, seed=h.random_seed,
        process_index=0, process_count=1)
    assert jd._chunk_dir == coop
    jd._executor.shutdown(wait=True, cancel_futures=True)

    single = dataset(h, scene, coop)
    shares = [dataset(h, scene, coop, process_index=i, process_count=WORLD)
              for i in range(WORLD)]
    try:
        for ds in [single] + shares:
            ds.load_chunk()
        rows = lambda d: {k: v for k, v in d._loaded.items()}  # noqa: E731
        whole = rows(single)
        for k, v in whole.items():
            merged = np.empty_like(v)
            for i, ds in enumerate(shares):
                merged[i::WORLD] = rows(ds)[k]
            np.testing.assert_array_equal(merged, v, err_msg=k)
        # every rank draws the same number of batches of its share
        n = [len(list(ds.sample_batches(h.batch_size // WORLD)))
             for ds in shares]
        assert n[0] == n[1] == len(whole["rgbs"]) // h.batch_size
    finally:
        for ds in [single] + shares:
            ds.close()


def test_chunk_write_handshake_without_a_group(scene, tmp_path):
    """Process ids given by hand (no process group): the writers start on
    process 0's ack of their nonce, and the directory is a single
    writer's."""
    h = mega_train_hparams(scene, "unused", "filesystem")
    made, errors = {}, []

    def write(i):
        try:
            made[i] = dataset(h, scene, tmp_path / "coop", process_index=i,
                              process_count=WORLD)
        except BaseException as e:    # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=write, args=(i,))
               for i in range(WORLD)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(made) == WORLD
    for ds in made.values():
        ds.close()
    dataset(h, scene, tmp_path / "one").close()
    assert_same_chunks(tmp_path / "coop", tmp_path / "one")
    assert not list((tmp_path / "coop").glob(".writer_*"))


def test_block_dataset_striding(job, block_scene, tmp_path):
    """Block-NeRF training in 2 ranks (rank 0 writes the chunks, rank 1
    waits for the manifest): the ranks bit-equal and finite. Each rank
    keeps rows [r::2] of a chunk: together they are the single-process
    chunk's rows, and each rank draws as many batches of half the global
    batch as one process draws of the whole."""
    ranks, dp_tmp = job
    outs = ranks.get("block")
    assert_ranks_equal(outs)
    assert outs[0]["step"] == 3
    assert all(np.isfinite(v) for m in outs[0]["metrics"] for v in m.values())
    h = block_runner_hparams(block_scene, "unused", "unused")
    r = trunner.Runner(h, set_experiment_path=False, device="cpu")
    kw = dict(data_path=block_scene["root"], near=r.near, far=r.far,
              scale_factor=h.train_scale_factor,
              list_path=block_scene["train"],
              id_map_path=block_scene["id_map"],
              chunk_paths=[dp_tmp / "block_chunks"],
              num_chunks=h.num_chunks, disk_flush_size=h.disk_flush_size,
              seed=h.random_seed)
    single = BlockFilesystemDataset(**kw)
    shares = [BlockFilesystemDataset(**kw, process_index=i,
                                     process_count=WORLD)
              for i in range(WORLD)]
    try:
        for ds in [single] + shares:
            ds.load_chunk()
        for k, v in single._loaded.items():
            merged = np.empty_like(v)
            for i, ds in enumerate(shares):
                merged[i::WORLD] = ds._loaded[k]
            np.testing.assert_array_equal(merged, v, err_msg=k)
        n = [len(list(ds.sample_batches(h.batch_size // WORLD)))
             for ds in shares]
        assert n[0] == n[1] == len(list(single.sample_batches(
            h.batch_size))) > 0
    finally:
        for ds in [single] + shares:
            ds.close()


def test_meters_merge_by_key(job):
    ranks, _ = job
    for out in ranks.get("meters"):
        assert out["gathered"] == [{"rank": 0, "k0": [0]},
                                   {"rank": 1, "k1": [1]}]
        assert out["means"] == {"psnr": 11.0, "ssim": (0.5 + 0.7 + 0.9) / 3,
                                "lpips-vgg": 0.25}


def test_refusals(job, scene):
    """resolve_device in a group; --expert_weight_parallel and
    --shard_optimizer_states take any mesh the processes fill (tests/
    test_torch_weight_parallel.py runs them); a mesh must hold the
    processes (tests/test_torch_expert_parallel.py runs expert
    parallelism)."""
    ranks, _ = job
    for r, out in enumerate(ranks.get("refusals")):
        assert out["explicit"] == "cpu"
        assert "none is available" in out["no_cuda"]
        assert "LOCAL_RANK 1" in out["too_few_cards"]
    h = mega_train_hparams(scene, "unused", "memory")
    for over in ({"expert_weight_parallel": True},
                 {"shard_optimizer_states": True}):
        g = mega_train_hparams(scene, "unused", "memory")
        for k, v in over.items():
            setattr(g, k, v)
        assert mesh_shape(g, 1) == (1, 1)
        g.mesh_shape = [4]
        assert mesh_shape(g, 4) == (4, 1)
        g.no_expert_parallel, g.mesh_shape = False, [2, 2]
        assert mesh_shape(g, 4) == (2, 2)
    g = mega_train_hparams(scene, "unused", "memory")
    g.mesh_shape = [2, 2]
    with pytest.raises(ValueError, match="number of processes"):
        mesh_shape(g, 1)
    g.no_expert_parallel, g.mesh_shape = False, [1, 3]
    with pytest.raises(ValueError, match="divide --moe_expert_num"):
        mesh_shape(g, 3)
    g.mesh_shape = None
    assert mesh_shape(g, 1) == (1, 1)
    h.mesh_shape = [2]
    with pytest.raises(ValueError, match="number of processes"):
        trunner.Runner(h, set_experiment_path=False, device="cpu")
    h.mesh_shape = [1, 1]
    assert mesh_shape(h, 1) == (1, 1)
    h.mesh_shape = None
    assert mesh_shape(h, 2) == (2, 1)


def test_entry_point_starts_and_ends_its_group(job):
    """train.main with torchrun's variables and no group of its caller's
    runs data-parallel and destroys the group it made."""
    ranks, _ = job
    outs = ranks.get("cli")
    assert_ranks_equal(outs)
    assert all(o["worlds"] == [WORLD, WORLD] for o in outs)
    assert not any(o["group_after"] for o in outs)


def test_help_starts_no_group(tmp_path):
    """--help under torchrun's variables prints usage and exits 0 without
    waiting for peers."""
    env = dict(os.environ, RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               SWITCH_NERF_ERROR_FILE=str(tmp_path / "err.json"))
    proc = subprocess.run(
        [sys.executable, "-m", "switch_nerf_torch.train", "--help"],
        env=env, cwd=str(_ROOT), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--batch_size" in proc.stdout
