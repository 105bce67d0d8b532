"""The port's orbax read (switch_nerf_torch/ocdbt.py, orbax_read.py,
checkpoints.load_checkpoint) against what JAX, orbax and tensorstore write
and read, on the CPU.

JAX's own ``switch_nerf_tpu.checkpoints.save_checkpoint`` writes one tiny
Building-graph train state (4 experts, Adam moments drawn from a seed,
step 3) twice: ``sharded=True`` on an expert-parallel (4, 2) mesh of the 8
virtual CPU devices (the experts and their moments over 'expert', as
``Runner._setup_device`` places them) and ``sharded=False``
(tests/make_orbax_fixture.py):

  * the port's OCDBT decoding equals ``tensorstore.ocdbt.dump`` for the
    root and process manifests, every B+tree node and every value; also
    for stores tensorstore writes with interior nodes and version tree
    nodes;
  * ``orbax_read.read_tree`` is the tree ``_msgpack.unpackb`` gives for
    the twin (keys in order, every leaf's dtype and bits), and
    ``load_checkpoint`` of either gives bit-equal states;
  * ``eval_image`` on each gives byte-equal metrics;
  * the same under --expert_weight_parallel and --shard_optimizer_states
    (the experts' columns and the other moments' first dimension over
    'data' too): the committed fixture tests/data/orbax_ewp_zero_fixture
    reads as its twin, and a state of the scene's model JAX wrote so
    resumes into a 2-rank weight-parallel ZeRO-1 run of the port, each
    rank holding JAX's device (d, 0) part of it, the run saving the
    twin's tree again;
  * a truncated or corrupted node or data file raises naming the file;
  * zarr chunks left out as equal to the fill value read as it;
  * (slow) the checkpoint 2 JAX processes write
    (tests/test_multihost.py::_run_workers) reads as orbax restores it.
"""
import gzip
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from switch_nerf_torch import _msgpack, bridge, ocdbt, orbax_read
from switch_nerf_torch.checkpoints import load_checkpoint
from switch_nerf_torch.models.model_utils import get_bg_nerf, get_nerf
from switch_nerf_torch.trainer import create_train_state
from switch_nerf_torch.parallel.mesh import Mesh
from tests.make_orbax_fixture import FIXTURE, FIXTURE_EWP_ZERO, write_pair
from tests.torch_port_helpers import (Ranks, mega_hparams, mega_train_hparams,
                                      with_val_image)

ts = pytest.importorskip("tensorstore")

APPEARANCE = 6          # the scene's images


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return with_val_image(tmp_path_factory.mktemp("mega"))


def ep_hparams(scene, exp):
    h = mega_hparams(scene, exp)
    h.no_expert_parallel = False
    h.mesh_shape = [4, 2]
    return h


@pytest.fixture(scope="module")
def pair(scene, tmp_path_factory):
    return write_pair(tmp_path_factory.mktemp("pair"),
                      ep_hparams(scene, "unused"), appearance=APPEARANCE)


def _walk(root: Path):
    """Every location of the store's tree: (tensorstore dump, port dump)."""
    base = ts.KvStore.open(f"file://{root}/").result()
    yield None, ts.ocdbt.dump(base).result(), ocdbt.dump(root)
    m = ts.ocdbt.dump(base).result()
    todo = [v["root"]["location"] for v in m["versions"]
            if "location" in v["root"]]
    todo += [v["location"] for v in m["version_tree_nodes"]]
    while todo:
        loc = todo.pop()
        want = ts.ocdbt.dump(base, loc).result()
        yield loc, want, ocdbt.dump(root, loc)
        if isinstance(want, dict):
            for e in want["entries"]:
                for ref in (e.get("location"), e.get("indirect_value"),
                            e.get("root", {}).get("location")):
                    if ref:
                        todo.append(ref)


def test_ocdbt_dump_equals_tensorstore(pair):
    root = pair["orbax"] / "orbax"
    stores = [root] + sorted(root.glob("ocdbt.process_*"))
    kinds = set()
    for store in stores:
        for loc, want, got in _walk(store):
            assert got == want, (store, loc)
            kinds.add(loc.split(":")[0] if loc else "manifest")
    # (a process manifest of more than 16 commits adds versionnode)
    assert {"manifest", "btreenode", "value"} <= kinds
    # the mapping: every key of the newest version, every value's bytes
    mine = ocdbt.open(root)
    theirs = ts.KvStore.open(f"file://{root}/|ocdbt:").result()
    keys = [k.decode() for k in theirs.list().result()]
    assert sorted(mine) == sorted(keys) and len(keys) > 100
    for k in keys:
        assert mine[k] == theirs[k.encode()], k


def test_ocdbt_interior_and_version_nodes(tmp_path):
    """A tensorstore store with 2,000-byte nodes (a tree of height 1) and
    40 commits (the version tree's interior nodes)."""
    small = tmp_path / "small"
    spec = ts.KvStore.Spec(f"file://{small}/|ocdbt:").to_json()
    spec["config"] = {"max_decoded_node_bytes": 2000,
                      "max_inline_value_bytes": 16}
    kv = ts.KvStore.open(spec).result()
    with ts.Transaction() as txn:
        for i in range(600):
            kv.with_transaction(txn)[b"key/%05d/x" % i] = \
                (b"v%d" % i) * (1 + i % 7)
    many = tmp_path / "many"
    kv2 = ts.KvStore.open(f"file://{many}/|ocdbt:").result()
    for i in range(40):
        kv2[b"k%03d" % i] = b"v" * i
    seen = set()
    for store, n_keys in ((small, 600), (many, 40)):
        for loc, want, got in _walk(store):
            assert got == want, (store, loc)
            seen.add((loc or "manifest").split(":")[0])
            if isinstance(want, dict) and "height" in want:
                seen.add(f"{(loc or '').split(':')[0]}{want['height']}")
        mine = ocdbt.open(store)
        assert len(mine) == n_keys
    assert {"btreenode1", "btreenode0", "versionnode1",
            "versionnode0"} <= seen


def same(a, b, path=()):
    """Two trees with the same keys in order and every leaf's dtype and
    bits."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        for k in b:
            same(a[k], b[k], path + (k,))
    elif torch.is_tensor(b):
        assert torch.is_tensor(a) and a.dtype == b.dtype, path
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_read_tree_equals_msgpack_twin(pair):
    tree = orbax_read.read_tree(pair["orbax"] / "orbax")
    twin = _msgpack.unpackb((pair["msgpack"] / "state.msgpack").read_bytes())
    same(tree, twin)
    assert int(tree["step"]) == 3 and tree["step"].shape == ()
    # the committed fixture (the card's) reads as its gzipped twin
    same(orbax_read.read_tree(FIXTURE / "orbax" / "3" / "orbax"),
         _msgpack.unpackb(gzip.decompress(
             (FIXTURE / "msgpack" / "3" / "state.msgpack.gz").read_bytes())))


def test_ewp_zero_fixture_reads_as_its_twin():
    """The committed fixture JAX wrote with its experts' columns and the
    moments cut over 'data' too reads as its gzipped twin."""
    meta = json.loads((FIXTURE_EWP_ZERO / "orbax" / "3" / "orbax"
                       / "_sharding").read_text())
    specs = [json.loads(v).get("partition_spec") for v in meta.values()]
    assert ["expert", None, "data"] in specs and ["data"] in specs
    same(orbax_read.read_tree(FIXTURE_EWP_ZERO / "orbax" / "3" / "orbax"),
         _msgpack.unpackb(gzip.decompress(
             (FIXTURE_EWP_ZERO / "msgpack" / "3" / "state.msgpack.gz")
             .read_bytes())))


def test_ewp_zero_orbax_resumes_into_two_ranks(scene, tmp_path):
    """A state of the scene's model that JAX wrote under
    --expert_parallel --expert_weight_parallel --shard_optimizer_states
    --mesh_shape 4 2 resumes into a 2-rank port run with
    --expert_weight_parallel --shard_optimizer_states --mesh_shape 2 1:
    each rank holds JAX's device (d, 0) part of the twin (its experts'
    column block, its moments' slices), and the run, with no step left,
    saves the twin's tree."""
    h = ep_hparams(scene, "unused")
    h.expert_weight_parallel = h.shard_optimizer_states = True
    dirs = write_pair(tmp_path / "pair", h, appearance=APPEARANCE)
    twin = _msgpack.unpackb((dirs["msgpack"] / "state.msgpack").read_bytes())
    t = mega_train_hparams(scene, tmp_path / "run", "memory")
    t.ckpt_path, t.train_iterations = str(dirs["orbax"]), 3
    t.mesh_shape, t.expert_weight_parallel = [2, 1], True
    t.shard_optimizer_states = True
    outs = Ranks(tmp_path / "job.pkl", [
        {"name": "resume", "kind": "train", "layout": True, "h": t}]).get(
            "resume")
    for r, out in enumerate(outs):
        assert out["step"] == 3 and not out["metrics"]
        assert out["optimizer"] == "ZeroAdam"
        part = bridge.local_tree(
            twin, Mesh(2, 1, r, None, None, None, expert_parallel=False,
                       weight_parallel=True, zero=True), h.moe_expert_num)
        flat = {"params": dict(bridge._flatten(part["params"])),
                "mu": dict(bridge._flatten(part["opt_state"]["0"]["mu"])),
                "nu": dict(bridge._flatten(part["opt_state"]["0"]["nu"]))}
        for kind, leaves in out["local"].items():
            assert sorted(leaves) == sorted(flat[kind])
            for path, local in leaves.items():
                assert local.tobytes() == flat[kind][path].tobytes(), path
        w0 = out["local"]["params"][("nerf", "layer_0", "experts", "w0")]
        assert w0.shape == (4, 16, 8)
    saved = _msgpack.unpackb((tmp_path / "run" / "0" / "models" / "3"
                              / "state.msgpack").read_bytes())
    same(saved, twin)


def _port_state(h):
    model = get_nerf(h, APPEARANCE, device="cpu")
    bg = get_bg_nerf(h, APPEARANCE, device="cpu")
    return create_train_state(h, model, bg, device="cpu")


def test_load_checkpoint_orbax_equals_msgpack(pair, scene):
    h = mega_hparams(scene, "unused")
    trees = []
    for d in (pair["orbax"], pair["msgpack"]):
        state, extra = load_checkpoint(d, _port_state(h),
                                       restore_rng_states=False)
        assert state.step == 3 and extra["iteration"] == 3
        trees.append(bridge.export_jax_train_state(state, state.rng))
    a, b = (dict(bridge._flatten(t)) for t in trees)
    assert list(a) == list(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_eval_image_orbax_equals_msgpack(pair, scene, tmp_path):
    from switch_nerf_torch import eval_image
    means = []
    for name in ("orbax", "msgpack"):
        h = mega_hparams(scene, tmp_path / name)
        h.ckpt_path = str(pair[name])
        means.append({k: v for k, v in eval_image.main(h, device="cpu")
                      .items() if k != "time"})    # wall seconds
    assert means[0] == means[1]
    assert np.isfinite(means[0]["psnr"])


def _copy(pair, tmp_path) -> Path:
    out = tmp_path / "ckpt" / "3"
    shutil.copytree(pair["orbax"], out)
    return out


def _root_node(step_dir: Path):
    root = step_dir / "orbax"
    loc = ocdbt.dump(root)["versions"][-1]["root"]["location"]
    _, base, rel, off, ln = loc.rsplit(":", 4)
    return root / base / rel, int(off), int(ln)


@pytest.mark.parametrize("damage", ["truncated node", "corrupt node",
                                    "truncated values"])
def test_damaged_checkpoint_raises_naming_the_file(pair, scene, tmp_path,
                                                    damage):
    step_dir = _copy(pair, tmp_path)
    if damage == "truncated values":
        # the data file of the newest tree's last value, cut inside it
        root = step_dir / "orbax"
        node = ocdbt.dump(root, ocdbt.dump(root)["versions"][-1]["root"][
            "location"])
        refs = [e["indirect_value"].rsplit(":", 4) for e in node["entries"]
                if "indirect_value" in e]
        _, base, rel, off, ln = max(refs, key=lambda r: int(r[3]) + int(r[4]))
        path = root / base / rel
        path.write_bytes(path.read_bytes()[:int(off) + int(ln) // 2])
    else:
        path, off, ln = _root_node(step_dir)
        raw = bytearray(path.read_bytes())
        if damage == "truncated node":
            raw = raw[:off + ln // 2]
        else:
            raw[off + ln // 2] ^= 0x40
        path.write_bytes(bytes(raw))
    with pytest.raises(ocdbt.OcdbtError, match=path.name):
        load_checkpoint(step_dir, _port_state(mega_hparams(scene, "u")),
                        restore_rng_states=False)


def test_chunks_left_out_read_as_the_fill_value():
    """zarr v2 arrays as orbax lays them out, with the chunks that equal
    the fill value left out (``store_array_data_equal_to_fill_value``
    false): every dtype the train state uses, a 0-d array, partial edge
    chunks and Fortran order, each chunk a zstd frame."""
    zstandard = pytest.importorskip("zstandard")
    rng = np.random.default_rng(0)
    arrays = {
        "f": (rng.standard_normal((5, 7, 3)).astype("<f4"), (2, 3, 2), "C",
              0.0),
        "i": (rng.integers(-9, 9, (6, 4)).astype("<i4"), (4, 4), "F", 0),
        "u": (rng.integers(0, 9, (9,)).astype("<u4"), (4,), "C", 7),
        "s": (np.asarray(11, "<i4"), (), "C", 0),
        "b": (rng.standard_normal((4, 6)).astype(np.float32), (2, 3), "C",
              0.0),
    }
    arrays["f"][0][:2, :3, :2] = 0.0           # a chunk equal to the fill
    arrays["u"][0][:4] = 7
    store = {}
    for name, (arr, chunks, order, fill) in arrays.items():
        raw = (torch.from_numpy(arr).to(torch.bfloat16).view(torch.int16)
               .numpy() if name == "b" else arr)
        store[f"{name}/.zarray"] = json.dumps({
            "chunks": list(chunks), "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".",
            "dtype": "bfloat16" if name == "b" else arr.dtype.str,
            "fill_value": fill, "filters": None, "order": order,
            "shape": list(arr.shape), "zarr_format": 2}).encode()
        grid = [range(-(-n // c)) for n, c in zip(arr.shape, chunks)]
        for idx in np.ndindex(*[len(g) for g in grid]):
            block = np.full(chunks, fill, raw.dtype)
            sl = tuple(slice(i * c, min((i + 1) * c, n))
                       for i, c, n in zip(idx, chunks, arr.shape))
            part = raw[sl]
            block[tuple(slice(0, x) for x in part.shape)] = part
            if np.all(block == fill) and name != "s":
                continue                      # left out
            key = ".".join(map(str, idx)) if idx else "0"
            store[f"{name}/{key}"] = zstandard.ZstdCompressor(
                level=1).compress(block.tobytes(order=order))
    assert "f/0.0.0" not in store and "u/0" not in store
    for name, (arr, *_) in arrays.items():
        got = orbax_read.read_array(store, name)
        if name == "b":
            assert torch.equal(got, torch.from_numpy(arr).to(torch.bfloat16))
        else:
            assert got.dtype == arr.dtype and got.shape == arr.shape
            np.testing.assert_array_equal(got, arr)


@pytest.mark.slow
def test_two_jax_processes_checkpoint_reads_as_orbax_restores(tmp_path):
    """The orbax checkpoint that 2 JAX processes write (each its
    addressable shards) reads, from the root manifest, as orbax restores
    it."""
    import orbax.checkpoint as ocp

    from tests.test_multihost import _run_workers
    _run_workers(2, tmp_path / "ckpt")
    step_dirs = sorted((d for d in (tmp_path / "ckpt").iterdir()
                        if (d / "orbax").exists()), key=lambda d: int(d.name))
    assert step_dirs
    root = step_dirs[-1] / "orbax"
    assert len(list(root.glob("ocdbt.process_*"))) == 2
    mine = orbax_read.read_tree(root)
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    with ocp.StandardCheckpointer() as c:
        meta = c.metadata(root).item_metadata
        theirs = c.restore(root, jax.tree_util.tree_map(
            lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=one),
            meta))

    def leaves(t, p=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, p + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from leaves(v, p + (str(i),))
        else:
            yield p, t
    got = dict(leaves(mine))
    for path, want in leaves(theirs):
        if want is None or (isinstance(want, dict) and not want):
            continue
        a = got[path]
        a = a.view(torch.int16).numpy() if torch.is_tensor(a) else a
        w = np.asarray(want)
        w = w.view(np.int16) if w.dtype.name == "bfloat16" else w
        assert a.tobytes() == w.tobytes(), path
    assert json.loads((step_dirs[-1] / "extra.json").read_text())
