"""Serving what users already have, port vs JAX package, on the CPU:

  * a reference-layout (MiZhenxing/Switch-NeRF) ``.pt`` checkpoint with
    random weights (the DDP ``module.`` prefix, the dense background
    NeRF) converted by ``python -m switch_nerf_torch.convert_torch_ckpt``
    and by ``scripts/convert_torch_ckpt.py``: the two checkpoints hold the
    same tree, leaf for leaf and bit for bit (the JAX PRNG key aside),
    and the weights drawn; the
    port's ``eval_image`` on its checkpoint equals JAX's on the script's
    (psnr to 1e-4 dB, ssim to 1e-5, LPIPS to 1e-4 relative);
  * ``eval_ckpt``: the same step and parameter count as JAX's;
  * containers both ways: a JAX container loads in the port and the
    port's (``convert_to_container_moe``, with its self-test) in JAX, the
    models' outputs within 1e-5; ``--container_path`` serves what
    ``--ckpt_path`` serves;
  * the LPIPS npz of ``convert_lpips_weights`` against
    ``scripts/convert_lpips_weights.py`` on a stand-in for ``lpips.LPIPS``
    (neither package depends on ``lpips``) with random weights of the real
    layouts: the same arrays and provenance record, each file readable by
    the other package.
"""
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from scripts import convert_lpips_weights as jlpips_script
from scripts import convert_torch_ckpt as jconvert
from switch_nerf_tpu import checkpoints as jckpt
from switch_nerf_tpu import container as jcontainer
from switch_nerf_tpu import lpips_jax
from switch_nerf_tpu import runner as jrunner
from switch_nerf_torch import _msgpack
from switch_nerf_torch import container as tcontainer
from switch_nerf_torch import convert_lpips_weights as tlpips_script
from switch_nerf_torch import convert_to_container_moe as tcontainer_cli
from switch_nerf_torch import convert_torch_ckpt as tconvert
from switch_nerf_torch import eval_ckpt as teval_ckpt
from switch_nerf_torch import eval_image as teval_image
from switch_nerf_torch import lpips_torch
from switch_nerf_torch import runner as trunner
from tests.test_torch_runner import assert_metrics_close
from tests.torch_port_helpers import (jax_train_state, make_mega_scene,
                                      mega_hparams, write_reference_pt)
# autouse: the JAX runners' template states from shapes
from tests.torch_port_helpers import jax_runners_from_shapes  # noqa: F401

ITERATION = 7


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_mega_scene(tmp_path_factory.mktemp("mega"))


def hp(scene, exp, **over):
    h = mega_hparams(scene, exp)
    for k, v in over.items():
        setattr(h, k, v)
    return h


@pytest.fixture(scope="module")
def converted(scene, tmp_path_factory):
    """The .pt, the weights it holds, and its port and JAX conversions."""
    tmp = tmp_path_factory.mktemp("convert")
    count = trunner.Runner(hp(scene, tmp / "e"), set_experiment_path=False,
                           device="cpu").appearance_count
    params = write_reference_pt(hp(scene, tmp / "e"), count, tmp / "ref.pt",
                                seed=3, iteration=ITERATION)
    out = {}
    for side in ("port", "jax"):
        h = hp(scene, tmp / f"{side}_exp", torch_ckpt=str(tmp / "ref.pt"),
               out_ckpt=str(tmp / side))
        if side == "port":
            tconvert.main(h, device="cpu")
        else:
            mp = pytest.MonkeyPatch()
            try:
                mp.setattr(jconvert, "parse_args", lambda parser: h)
                jconvert.main()
            finally:
                mp.undo()
        out[side] = tmp / side / str(ITERATION)
    return params, out, count


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_converter_matches_the_script(converted):
    params, out, _ = converted
    trees = {side: dict(flat(_msgpack.unpackb(
        (d / "state.msgpack").read_bytes()))) for side, d in out.items()}
    assert sorted(trees["port"]) == sorted(trees["jax"])
    for path, want in trees["jax"].items():
        got = trees["port"][path]
        if path == ("rng",):
            # the JAX runner's PRNG key, which the port carries opaquely
            # and never draws from: its own [0, seed]
            assert got.dtype == want.dtype and got.shape == want.shape
            continue
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    drawn = dict(flat(params))
    assert len(drawn) == sum(1 for p in trees["port"] if p[0] == "params")
    for path, want in drawn.items():
        np.testing.assert_array_equal(trees["port"][("params",) + path],
                                      want, err_msg=str(path))
    extras = [json.loads((d / "extra.json").read_text())
              for d in out.values()]
    assert extras[0]["iteration"] == extras[1]["iteration"] == ITERATION
    assert extras[0]["param_fingerprint"] == extras[1]["param_fingerprint"]


def test_converter_warns_on_missing_leaves(converted, scene, tmp_path,
                                           capsys):
    """A .pt without the gate LayerNorm: the script's warning, the leaves
    kept initialised."""
    sd = torch.load(converted[1]["port"].parent.parent / "ref.pt",
                    weights_only=False)
    sd["model_state_dict"] = {k: v for k, v in sd["model_state_dict"].items()
                              if ".gate_input_norm." not in k}
    torch.save(sd, tmp_path / "cut.pt")
    tconvert.main(hp(scene, tmp_path / "e", torch_ckpt=str(tmp_path /
                                                           "cut.pt"),
                     out_ckpt=str(tmp_path / "out")), device="cpu")
    msg = capsys.readouterr().out
    assert "WARNING: nerf: 2 params not found" in msg
    assert "layer_gate_input_norm.weight" in msg


def test_eval_on_converted_matches_jax(converted, scene, tmp_path):
    _, out, _ = converted
    tmeans = teval_image.main(hp(scene, tmp_path / "t",
                                 ckpt_path=str(out["port"])), device="cpu")
    jmeans = jrunner.Runner(hp(scene, tmp_path / "j",
                               ckpt_path=str(out["jax"]))).eval_image()
    assert_metrics_close(tmeans, jmeans)


def test_eval_ckpt_matches_jax(converted, scene, tmp_path):
    _, out, _ = converted
    state = teval_ckpt.main(hp(scene, tmp_path / "t",
                               ckpt_path=str(out["port"])), device="cpu")
    jstate = jrunner.Runner(hp(scene, tmp_path / "j",
                               ckpt_path=str(out["jax"])),
                            set_experiment_path=False).eval_ckpt()
    n = sum(p.numel() for p in state.parameters())
    assert n == jrunner.count_parameters(jstate.params) > 0
    assert state.step == int(jstate.step) == ITERATION


def _points(count, n=96, seed=5):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([rng.uniform(-0.5, 0.5, (n, 3)), d,
                           rng.integers(0, count, (n, 1))], -1
                          ).astype(np.float32)


def _jax_state(h, count, ckpt):
    from switch_nerf_tpu.models import model_utils as jmu
    state = jax_train_state(
        jax.random.PRNGKey(0), h, jmu.get_nerf(h, count),
        jmu.get_bg_nerf(h, count))
    return jckpt.load_checkpoint(ckpt, state, restore_rng_states=False)[0]


def _assert_same_outputs(tmodel, tbg, jnerf, jbg, params, count):
    pts = _points(count)
    bg_pts = np.concatenate([pts[:, :3], np.ones((len(pts), 1), np.float32),
                             pts[:, 3:]], -1)
    for tm, jm, key, x in ((tmodel, jnerf, "nerf", pts),
                           (tbg, jbg, "bg_nerf", bg_pts)):
        with torch.no_grad():
            got = tm(torch.from_numpy(x), train=False)
        got = got["outputs"] if isinstance(got, dict) else got
        want = jm.apply({"params": params[key]}, x, deterministic=True)
        want = want["outputs"] if isinstance(want, dict) else want
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_jax_container_loads_in_the_port(converted, scene, tmp_path):
    _, out, count = converted
    h = hp(scene, tmp_path / "e")
    state = _jax_state(h, count, out["jax"])
    path = jcontainer.save_container(tmp_path / "c", h, state.params, count,
                                     scene={"near": 0.5})
    model, bg, cfg = tcontainer.load_container(path, device="cpu")
    assert cfg["appearance_count"] == count and cfg["scene"]["near"] == 0.5
    jnerf, jbg, jparams, _ = jcontainer.load_container(path)
    _assert_same_outputs(model, bg, jnerf, jbg, jparams, count)


def test_port_container_loads_in_jax(converted, scene, tmp_path, capsys):
    _, out, count = converted
    h = hp(scene, tmp_path / "e", ckpt_path=str(out["port"]),
           container_out=str(tmp_path / "c"))
    path = tcontainer_cli.main(h, device="cpu")
    assert "container self-test OK" in capsys.readouterr().out
    cfg = json.loads((path / "model_config.json").read_text())
    assert sorted(cfg) == sorted(jcontainer._MODEL_KEYS
                                 + ["appearance_count", "scene"])
    assert cfg["scene"]["near"] == pytest.approx(0.05)
    jnerf, jbg, jparams, _ = jcontainer.load_container(path)
    model, bg, _ = tcontainer.load_container(path, device="cpu")
    _assert_same_outputs(model, bg, jnerf, jbg, jparams, count)


def test_container_path_serves_the_checkpoint(converted, scene, tmp_path):
    _, out, _ = converted
    h = hp(scene, tmp_path / "e", ckpt_path=str(out["port"]),
           container_out=str(tmp_path / "c"))
    tcontainer_cli.main(h, device="cpu")
    from_ckpt = teval_image.main(hp(scene, tmp_path / "a",
                                    ckpt_path=str(out["port"])),
                                 device="cpu")
    from_container = teval_image.main(
        hp(scene, tmp_path / "b", container_path=str(tmp_path / "c")),
        device="cpu")
    assert from_container.keys() == from_ckpt.keys()
    for k, v in from_ckpt.items():
        if k not in ("time", "memory"):
            assert from_container[k] == v, k


class _Lin:
    def __init__(self, c, gen):
        self.model = torch.nn.Sequential(torch.nn.Dropout(),
                                         torch.nn.Conv2d(c, 1, 1, bias=False))
        with torch.no_grad():
            self.model[-1].weight.copy_(torch.rand(1, c, 1, 1, generator=gen))


def stand_in_lpips(net, seed):
    """An object shaped like ``lpips.LPIPS(net=net)``: ``.net`` holds the
    backbone's Conv2d layers in order (the consumer's layout), ``.lins``
    the learned 1x1 weights, all drawn from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    layout = lpips_torch.expected_layout(net)
    convs = []
    i = 0
    while f"conv{i}/kernel" in layout:
        kh, kw, cin, cout = layout[f"conv{i}/kernel"]
        conv = torch.nn.Conv2d(cin, cout, (kh, kw))
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen))
        convs.append(conv)
        i += 1
    lins = []
    while f"lin{len(lins)}/kernel" in layout:
        lins.append(_Lin(layout[f"lin{len(lins)}/kernel"][2], gen))
    return SimpleNamespace(net=torch.nn.Sequential(*convs), lins=lins)


def test_lpips_npz_matches_the_script(tmp_path):
    models = {net: stand_in_lpips(net, seed)
              for seed, net in enumerate(("vgg", "alex", "squeeze"))}
    meta = {"lpips_version": "stand-in", "torch_version": torch.__version__,
            "converted": "2026-01-01T00:00:00+00:00"}
    t_sha = tlpips_script.convert(models, str(tmp_path / "port.npz"), meta)
    nets = {}
    for net, model in models.items():
        out = {}
        jlpips_script._export_net(model, net, out)
        nets[net] = {k.split("/", 1)[1]: v for k, v in out.items()}
    j_sha = lpips_jax.write_weights_npz(str(tmp_path / "jax.npz"), nets,
                                        meta)
    assert len(t_sha) == len(j_sha) == 64
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # each package reads the other's file, checksums verified
    got = lpips_torch.load_and_validate(str(tmp_path / "jax.npz"))
    want = lpips_jax.load_and_validate(str(tmp_path / "port.npz"))
    assert sorted(got) == sorted(want) == ["alex", "squeeze", "vgg"]
    for net in got:
        for k, v in want[net].items():
            np.testing.assert_array_equal(got[net][k], v)
    assert lpips_torch.read_provenance(str(tmp_path / "port.npz"))[
        "checksums"] == lpips_jax.read_provenance(str(tmp_path / "jax.npz"))[
        "checksums"]
