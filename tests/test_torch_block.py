"""The port's Block-NeRF (Mission Bay) modules vs the JAX package's, on the
CPU: the tfrecord reader and writer (``datasets/tfrecord.py``), the chunked
``BlockFilesystemDataset``, ``MipNeRFMoE`` with appearance at width 512,
the expert chain at M = 512, the Mission Bay checkpoint both ways, and the
entry points' device rule. ``Runner.train`` and
``Runner.eval_image_blocknerf``: tests/test_torch_block_runner.py.

Scenes are synthetic GZIP tfrecords written by ``chip_smoke.make_block_scene``
(the port's writer, seeded). The JAX package reads records through
TensorFlow, so every test that runs a JAX Block-NeRF loader asks for it
(``pytest.importorskip("tensorflow")``); the port's reader and writer are
also tested without it.

Tolerances: tfrecord decode exact (images uint8-equal, floats bit-equal);
dataset rays and radii 1e-6 (the same float32 arithmetic); the model and
the chain 1e-5 (float32 products in another order; dW relative to its
largest entry); checkpoints leaf-equal and byte-identical.
"""
import copy
import gzip
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu.models import model_utils as jmu
from switch_nerf_tpu.ops import expert_kernel as jek
from switch_nerf_torch import bridge
from switch_nerf_torch import checkpoints as tckpt
from switch_nerf_torch import eval_image_blocknerf as teval
from switch_nerf_torch import train as ttrain
from switch_nerf_torch import trainer as ttrainer
from switch_nerf_torch.datasets import block_filesystem_dataset as tbd
from switch_nerf_torch.datasets import tfrecord as T
from switch_nerf_torch.models import model_utils as tmu
from switch_nerf_torch.ops import expert_kernel
from tests.torch_port_helpers import (BLOCK_RECORDS, block_runner_hparams,
                                      jax_train_state, make_block_test_scene,
                                      mission_bay_hparams)


def _close(out, ref, tol, rel=False, err_msg=""):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30) if rel else 1.0
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, (err_msg, err, tol * scale)


@pytest.fixture(autouse=True)
def _crash_reports_in_tmp(tmp_path, monkeypatch):
    """The entry points' crash reports go to the test's directory."""
    monkeypatch.setenv("SWITCH_NERF_ERROR_FILE", str(tmp_path / "err.json"))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_block_test_scene(tmp_path_factory.mktemp("mission_bay"))


# ------------------------------------------------------------ tfrecord ---
def _bytewise_crc32c(data: bytes) -> int:
    reg = 0xFFFFFFFF
    for b in data:
        reg ^= b
        for _ in range(8):
            reg = (reg >> 1) ^ (0x82F63B78 if reg & 1 else 0)
    return reg ^ 0xFFFFFFFF


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 63, 1000, 65537])
def test_crc32c_matches_a_bytewise_reference(n):
    assert T.crc32c(b"123456789") == 0xE3069283     # the check value
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert T.crc32c(data) == _bytewise_crc32c(data)


def _example(rng, h=5, w=7):
    return {"image_hash": ("int64", [-(2 ** 63) + 5]),
            "big": ("int64", np.array([2 ** 62, -1, 0, 127, 128, 300])),
            "exposure": ("float", [0.1]),
            "rays": ("float", rng.normal(size=(h, w, 3)).astype(np.float32)),
            "image": ("bytes", [T.encode_png(rng.integers(
                0, 256, (h, w, 3), np.uint8))]),
            "empty": ("float", np.zeros(0, np.float32))}


def test_records_round_trip_without_tensorflow(tmp_path):
    rng = np.random.default_rng(0)
    examples = [_example(rng) for _ in range(3)]
    path = tmp_path / "r.tfrecord"
    T.write_examples(path, examples)
    got = list(T.read_examples(path))
    assert len(got) == 3
    for g, e in zip(got, examples):
        assert sorted(g) == sorted(e)
        for k, (kind, values) in e.items():
            assert g[k][0] == kind, k
            if kind == "bytes":
                assert g[k][1] == values
            else:
                np.testing.assert_array_equal(
                    g[k][1], np.asarray(values).reshape(-1).astype(
                        g[k][1].dtype), err_msg=k)
    img = T.decode_png(got[0]["image"][1][0])
    assert img.shape == (5, 7, 3) and img.dtype == np.uint8
    assert T.decode_png(T.encode_png(img[..., :1])).shape == (5, 7, 1)

    # a flipped data byte, a flipped length byte, a cut file
    raw = bytearray(Path(path).read_bytes())
    plain = bytearray(gzip.decompress(bytes(raw)))
    for pos in (20, 2):
        bad = bytearray(plain)
        bad[pos] ^= 1
        (tmp_path / "bad").write_bytes(gzip.compress(bytes(bad)))
        with pytest.raises(ValueError, match="corrupted"):
            list(T.read_records(tmp_path / "bad"))
    (tmp_path / "cut").write_bytes(gzip.compress(bytes(plain[:-3])))
    with pytest.raises(ValueError, match="truncated"):
        list(T.read_records(tmp_path / "cut"))


def _field(num, wire, payload):
    key = T._encode_varint((num << 3) | wire)
    if wire == 2:
        return key + T._encode_varint(len(payload)) + payload
    return key + payload


def test_unpacked_repeated_fields_parse():
    """TensorFlow writes repeated numbers packed; a parser must also take
    them one field each (float as fixed32, int64 as varints)."""
    floats = b"".join(_field(1, 5, struct.pack("<f", v))
                      for v in (1.5, -2.25))
    ints = b"".join(_field(1, 0, T._encode_varint(v)) for v in (7, -3))
    feats = (_field(1, 2, _field(1, 2, b"f") + _field(2, 2, _field(2, 2,
                                                                   floats)))
             + _field(1, 2, _field(1, 2, b"i") + _field(2, 2, _field(
                 3, 2, ints))))
    ex = T.parse_example(_field(1, 2, feats))
    np.testing.assert_array_equal(ex["f"][1], np.float32([1.5, -2.25]))
    np.testing.assert_array_equal(ex["i"][1], np.int64([7, -3]))


def test_port_reads_tensorflow_records(tmp_path):
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(1)
    imgs, floats, path = [], [], tmp_path / "tf.tfrecord"
    with tf.io.TFRecordWriter(str(path), options="GZIP") as wr:
        for i in range(2):
            img = rng.integers(0, 256, (6, 9, 3), np.uint8)
            vals = rng.normal(size=54).astype(np.float32)
            imgs.append(img)
            floats.append(vals)
            feats = {
                "image": tf.train.Feature(bytes_list=tf.train.BytesList(
                    value=[tf.io.encode_png(img).numpy()])),
                "ray_dirs": tf.train.Feature(float_list=tf.train.FloatList(
                    value=vals)),
                "image_hash": tf.train.Feature(int64_list=tf.train.Int64List(
                    value=[-(2 ** 62) - i])),
                "mask": tf.train.Feature(int64_list=tf.train.Int64List(
                    value=rng.integers(0, 2, 54)))}
            wr.write(tf.train.Example(features=tf.train.Features(
                feature=feats)).SerializeToString())
    for i, ex in enumerate(T.read_examples(path)):
        png = ex["image"][1][0]
        np.testing.assert_array_equal(T.decode_png(png), imgs[i])
        np.testing.assert_array_equal(
            T.decode_png(png), tf.io.decode_png(png, channels=0).numpy())
        assert ex["ray_dirs"][1].tobytes() == floats[i].tobytes()
        assert ex["image_hash"][1].tolist() == [-(2 ** 62) - i]
        assert ex["mask"][1].shape == (54,)


def test_tensorflow_reads_port_records(tmp_path):
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(2)
    examples = [_example(rng) for _ in range(2)]
    path = tmp_path / "port.tfrecord"
    T.write_examples(path, examples)
    schema = {"image_hash": tf.io.FixedLenFeature([], tf.int64),
              "exposure": tf.io.FixedLenFeature([], tf.float32),
              "image": tf.io.FixedLenFeature([], tf.string),
              "big": tf.io.VarLenFeature(tf.int64),
              "rays": tf.io.VarLenFeature(tf.float32),
              "empty": tf.io.VarLenFeature(tf.float32)}
    n = 0
    for rec, e in zip(tf.data.TFRecordDataset(str(path), "GZIP"), examples):
        b = tf.io.parse_single_example(rec, schema)
        assert int(b["image_hash"]) == -(2 ** 63) + 5
        np.testing.assert_array_equal(
            tf.sparse.to_dense(b["big"]).numpy(), e["big"][1])
        assert tf.sparse.to_dense(b["rays"]).numpy().tobytes() == \
            e["rays"][1].reshape(-1).tobytes()
        assert tf.sparse.to_dense(b["empty"]).numpy().size == 0
        np.testing.assert_array_equal(
            tf.io.decode_png(b["image"], channels=0).numpy(),
            T.decode_png(e["image"][1][0]))
        n += 1
    assert n == 2


# ------------------------------------------------------------- dataset ---
def _jax_bd():
    pytest.importorskip("tensorflow")
    from switch_nerf_tpu.datasets import block_filesystem_dataset as jbd
    return jbd


@pytest.mark.parametrize("load_mask", [False, True])
def test_load_tfrecord_matches_jax(scene, load_mask):
    jbd = _jax_bd()
    rec = scene["root"] / BLOCK_RECORDS[1][0]
    id_map = tbd.record_id_map(json.loads(scene["id_map"].read_text()), rec)
    got = tbd.load_tfrecord(rec, id_map, 1.0, 10.0, load_mask=load_mask)
    want = jbd.load_tfrecord(rec, id_map, 1.0, 10.0, load_mask=load_mask)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype, k
                tol = 1e-6 if k in ("rays", "radii") else 0.0
                np.testing.assert_allclose(g[k], v, rtol=0, atol=tol,
                                           err_msg=k)
            else:
                assert g[k] == v, k
    assert load_mask == ("mask" in got[0])


def _datasets(jbd, scene, root, shuffle):
    kw = dict(data_path=scene["root"], near=1.0, far=10.0, scale_factor=2,
              list_path=scene["train"], id_map_path=scene["id_map"],
              num_chunks=3, disk_flush_size=50, shuffle_chunk=shuffle,
              seed=5)
    j = jbd.BlockFilesystemDataset(chunk_paths=[root / "jax"], **kw,
                                   process_index=0, process_count=1)
    t = tbd.BlockFilesystemDataset(chunk_paths=[root / "port"], **kw)
    return j, t


@pytest.mark.parametrize("shuffle", [False, True])
def test_block_dataset_matches_jax(scene, tmp_path, shuffle):
    """The same records -> the same chunk parts (validation images: their
    left halves; --train_scale_factor 2), manifests, batches and cursors;
    a cursor saved by either package restores the other's."""
    jbd = _jax_bd()
    j, t = _datasets(jbd, scene, tmp_path, shuffle)
    try:
        jparts = sorted(p.relative_to(tmp_path / "jax")
                        for p in (tmp_path / "jax").rglob("*.npz"))
        tparts = sorted(p.relative_to(tmp_path / "port")
                        for p in (tmp_path / "port").rglob("*.npz"))
        assert jparts == tparts and len(jparts) > 3
        for p in jparts:
            with np.load(tmp_path / "jax" / p) as a, \
                    np.load(tmp_path / "port" / p) as b:
                assert a.files == b.files
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=str(p))
        assert json.loads((tmp_path / "jax" / "manifest.json").read_text()) \
            == json.loads((tmp_path / "port" / "manifest.json").read_text())
        for _ in range(4):              # past the 3 chunks: the cycle wraps
            j.load_chunk()
            t.load_chunk()
            assert len(j) == len(t)
            for bj, bt in zip(j.sample_batches(16), t.sample_batches(16)):
                assert sorted(bj) == sorted(bt) == [
                    "image_indices", "radii", "rays", "rgbs"]
                for k in bj:
                    np.testing.assert_allclose(bt[k], bj[k], rtol=0,
                                               atol=1e-6, err_msg=k)
            assert j.get_state() == t.get_state()
        state = t.get_state()
        j.set_state(state)
        t.set_state(j.get_state())
        j.load_chunk()
        t.load_chunk()
        bj, bt = next(j.sample_batches(16)), next(t.sample_batches(16))
        np.testing.assert_array_equal(bt["rgbs"], bj["rgbs"])
    finally:
        t.close()


def test_chunk_dirs_move_between_packages(scene, tmp_path):
    """A chunk directory written by either package is reused by the other
    (its manifest matches), and different settings are refused."""
    jbd = _jax_bd()
    j, t = _datasets(jbd, scene, tmp_path, False)
    t.close()
    kw = dict(data_path=scene["root"], near=1.0, far=10.0, scale_factor=2,
              list_path=scene["train"], id_map_path=scene["id_map"],
              num_chunks=3, disk_flush_size=50, seed=5)
    before = sorted(p.stat().st_mtime_ns
                    for p in (tmp_path / "jax").rglob("*.npz"))
    t2 = tbd.BlockFilesystemDataset(chunk_paths=[tmp_path / "jax"], **kw)
    t2.close()
    j2 = jbd.BlockFilesystemDataset(chunk_paths=[tmp_path / "port"], **kw,
                                    process_index=0, process_count=1)
    assert sorted(p.stat().st_mtime_ns
                  for p in (tmp_path / "jax").rglob("*.npz")) == before
    j2.load_chunk()
    assert len(j2) > 0
    with pytest.raises(ValueError, match="different settings"):
        tbd.BlockFilesystemDataset(chunk_paths=[tmp_path / "jax"],
                                   **{**kw, "num_chunks": 4})


# --------------------------------------------------------------- model ---
@pytest.fixture(scope="module")
def mission_bay_jax():
    """The published Mission Bay model graph (512 wide, appearance_dim 48
    over 5 rows, external gate + LayerNorm) cut to 2 experts x 3 layers,
    and a JAX train state of it."""
    h = mission_bay_hparams()
    assert h.appearance_dim == 48 and h.model["layers"]["0"]["out_ch"] == 512
    jm = jmu.get_nerf(h, 5)
    return h, jm, jax_train_state(jax.random.PRNGKey(1), h, jm, None)


def test_mip_nerf_moe_with_appearance_at_width_512_matches_jax(
        mission_bay_jax):
    """From JAX's init through the bridge: outputs and the MoE loss within
    1e-5."""
    h, jm, jstate = mission_bay_jax
    params = jstate.params
    tm = tmu.get_nerf(h, 5, device="cpu")
    bridge.load_jax_params(tm, jax.tree_util.tree_map(np.asarray,
                                                      params["nerf"]))
    rng = np.random.default_rng(6)
    pts = np.concatenate([rng.normal(0, 1, (64, 3)),
                          rng.uniform(0, 1e-3, (64, 3)),
                          rng.normal(0, 1, (64, 3)),
                          rng.integers(0, 5, (64, 1))], -1).astype(np.float32)
    ref = jm.apply({"params": params["nerf"]}, jnp.asarray(pts))
    with torch.no_grad():
        out = tm(torch.from_numpy(pts))
    _close(out["outputs"], ref["outputs"], 1e-5, err_msg="outputs")
    _close(out["extras"]["moe_loss"], ref["extras"]["moe_loss"], 1e-5,
           rel=True, err_msg="moe_loss")


@pytest.mark.parametrize("layers,skips", [(3, (1,)), (7, (3,))])
def test_chain_at_width_512_matches_pallas(layers, skips):
    """The plain chain and its backward at M = 512 (the card kernels' new
    width) vs the Pallas kernels in interpret mode, fp32."""
    rng = np.random.default_rng(layers)
    x = rng.normal(0, 1, (2, 16, 512)).astype(np.float32)
    ws = rng.normal(0, 0.04, (layers, 2, 512, 512)).astype(np.float32)
    bs = rng.normal(0, 0.1, (layers, 2, 1, 512)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    ref = jek.expert_mlp_chain(*map(jnp.asarray, (x, ws, bs)), skips=skips,
                               interpret=True)
    tx, tws, tbs, tg = map(torch.from_numpy, (x, ws, bs, g))
    _close(expert_kernel.expert_mlp_chain(tx, tws, tbs, skips), ref, 1e-5,
           rel=True, err_msg="out")
    jdx, jdw, jdb = jek._bwd_call(*map(jnp.asarray, (x, ws, bs, g)), skips,
                                  interpret=True)
    dx, dw, db = expert_kernel.expert_mlp_chain_bwd_plain(tx, tws, tbs, tg,
                                                          skips)
    _close(dx, jdx, 1e-5, rel=True, err_msg="dx")
    _close(dw, jdw, 1e-5, rel=True, err_msg="dW")
    _close(db, jdb, 1e-5, rel=True, err_msg="db")


def test_mission_bay_checkpoint_crosses_both_ways(mission_bay_jax, tmp_path):
    """A JAX Mission Bay checkpoint loads into the port leaf for leaf, and
    the port's checkpoint of it loads back into JAX with the same leaves
    and state.msgpack bytes."""
    from flax import serialization
    h, jm, jstate = mission_bay_jax
    jckpt.save_checkpoint(tmp_path / "jax", jstate)
    ts = ttrainer.create_train_state(h, tmu.get_nerf(h, 5, device="cpu"),
                                     None, device="cpu")
    ts, _ = tckpt.load_checkpoint(tmp_path / "jax", ts,
                                  restore_rng_states=False)
    assert tuple(ts.model.embedding_a.weight.shape) == (5, 48)
    want = jax.device_get(jckpt._state_tree(jstate))
    got = bridge.export_jax_train_state(ts, ts.rng)
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(
                serialization.to_state_dict(want))}
    flat_got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_leaves_with_path(
                    serialization.to_state_dict(got))}
    assert sorted(flat) == sorted(flat_got)
    for k, v in flat.items():
        np.testing.assert_array_equal(flat_got[k], v, err_msg=k)
    out = tckpt.save_checkpoint(tmp_path / "port", ts)
    restored, _ = jckpt.load_checkpoint(
        tmp_path / "port",
        jax_train_state(jax.random.PRNGKey(2), h, jm, None))
    assert (out / "state.msgpack").read_bytes() == \
        (tmp_path / "jax" / "0" / "state.msgpack").read_bytes()
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.device_get(jckpt._state_tree(restored)), want)


def test_block_entry_points_need_a_card_unless_cpu(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    h = block_runner_hparams(scene, tmp_path / "t", tmp_path / "c")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(copy.copy(h))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.main(copy.copy(h))
    h.dataset_type = "memory"
    with pytest.raises(ValueError, match="filesystem"):
        ttrain.main(copy.copy(h), device="cpu")
