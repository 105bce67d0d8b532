"""The port's LPIPS (lpips_torch.py) vs the JAX package's lpips_jax.py, on
the CPU: the substitute weights bit-equal, distances on 64x64 (and
smaller-than-receptive-field) images to 1e-4 relative, and the converted
weights npz contract (layout and provenance checks) the same.
"""
import zipfile

import numpy as np
import pytest

from switch_nerf_tpu import lpips_jax as jl
from switch_nerf_tpu import metrics as jm
from switch_nerf_torch import lpips_torch as tl
from switch_nerf_torch import metrics as tm


def assert_close(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert abs(got[k] - v) <= 1e-4 * abs(v), (k, got[k], v)


@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze"])
def test_substitute_weights_bit_equal(net):
    want, got = jl.substitute_weights(net), tl.substitute_weights(net)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tl.expected_layout(net) == jl.expected_layout(net)
    assert tl.net_checksum(got) == jl.net_checksum(want)


@pytest.mark.parametrize("hw", [(64, 64), (6, 4)])
def test_lpips_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    x = rng.uniform(-1, 1, hw + (3,)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, x.shape), -1, 1).astype(np.float32)
    nets = {n: jl.substitute_weights(n) for n in tl.NETS}
    assert_close(tl.lpips_all_from_nets(x, y, nets),
                 jl.lpips_all_from_nets(x, y, nets))


@pytest.fixture(scope="module")
def squeeze_npz(tmp_path_factory):
    """A provenance-stamped npz of the squeeze substitute, written by the
    JAX package's converter helper."""
    path = tmp_path_factory.mktemp("lpips") / "squeeze.npz"
    jl.write_weights_npz(path, {"squeeze": jl.substitute_weights("squeeze")},
                         {"source": "test"})
    return path


def test_weights_file_matches_jax(squeeze_npz, monkeypatch):
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    assert tl.read_provenance(str(squeeze_npz)) == \
        jl.read_provenance(str(squeeze_npz))
    assert_close(tl.lpips_all(x, y, str(squeeze_npz)),
                 jl.lpips_all(x, y, str(squeeze_npz)))
    monkeypatch.setenv("SWITCH_NERF_LPIPS_WEIGHTS", str(squeeze_npz))
    assert tm.validate_lpips_setup() == str(squeeze_npz)
    got, want = tm.lpips(x, y), jm.lpips(x, y)
    assert got["vgg"] is None and got["squeeze"] > 0
    assert_close(got, want)


def test_flipped_byte_rejected(squeeze_npz, tmp_path):
    """A byte flipped in the file (caught by the zip layer or the layout
    check) and a byte flipped inside a tensor with the provenance record
    kept (caught by the sha256) are refused by both loaders."""
    raw = bytearray(squeeze_npz.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    flipped = tmp_path / "flipped.npz"
    flipped.write_bytes(bytes(raw))
    for mod in (tl, jl):
        with pytest.raises((ValueError, zipfile.BadZipFile)):
            mod.load_and_validate(str(flipped))

    with np.load(squeeze_npz) as data:
        arrays = {k: data[k].copy() for k in data.files}
    kernel = arrays["squeeze/conv4/kernel"]
    kernel.view(np.uint8).reshape(-1)[5] ^= 0x01
    tampered = tmp_path / "tampered.npz"
    np.savez(tampered, **arrays)
    for mod in (tl, jl):
        with pytest.raises(ValueError, match="provenance sha256"):
            mod.load_and_validate(str(tampered))

    del arrays["squeeze/lin0/kernel"]
    missing = tmp_path / "missing.npz"
    np.savez(missing, **arrays)
    with pytest.raises(ValueError, match="missing squeeze/lin0/kernel"):
        tl.load_and_validate(str(missing))
