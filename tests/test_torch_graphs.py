"""CUDA graphs for the eval step's whole-chunk model calls
(``switch_nerf_torch/graphs.py``).

On the CPU: which calls qualify, that the wrapped model function and the
eval step return exactly what the plain ones return (a CPU call never
qualifies), and the graph key. On the card (marked ``cuda``, skipped
without one): a replay gives the eager call's bits over three chunks held
at once, after an in-place weight change and after the weights move to
new storage; the tail chunk runs eagerly; the graph's kernels show in the
profiler one by one under their own names. This file imports no JAX, so
on a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py -q
"""
import types
from collections import Counter

import pytest
import torch

from switch_nerf_torch import graphs
from switch_nerf_torch.models.model_utils import get_bg_nerf, get_nerf
from switch_nerf_torch.models.moe import MoELayer
from switch_nerf_torch.ops import ragged_chain
from switch_nerf_torch.profile_eval import (building_eval_hparams,
                                            mission_bay_train_hparams,
                                            ray_batch)
from switch_nerf_torch.render.rendering import render_rays
from switch_nerf_torch.trainer import (SceneInfo, make_eval_step,
                                       make_model_fn, make_model_fn_pair,
                                       render_config_from_hparams)

ROWS = 64


def _layer(kind: str) -> MoELayer:
    g = torch.Generator().manual_seed(0)
    if kind.startswith("ffn"):
        hidden = 16 if kind == "ffn H == M" else 32
        return MoELayer(16, 4, expert_type="ffn", ffn_hidden_size=hidden,
                        generator=g)
    layer = MoELayer(16, 4, layer_num=2, generator=g)
    if kind == "expert parallel":
        layer.experts.ep = object()        # a mesh: the layer exchanges
    return layer


# (model, rows, grad, train, sigma noise, on CUDA) -> qualifies
QUALIFY = {
    "full chunk": (("expertmlp", ROWS, False, False, False, True), True),
    "tail chunk": (("expertmlp", ROWS - 1, False, False, False, True),
                   False),
    "grad enabled": (("expertmlp", ROWS, True, False, False, True), False),
    "train": (("expertmlp", ROWS, False, True, False, True), False),
    "sigma noise": (("expertmlp", ROWS, False, False, True, True), False),
    "expert parallel": (("expert parallel", ROWS, False, False, False, True),
                        False),
    "ffn H != M": (("ffn H != M", ROWS, False, False, False, True), False),
    "ffn H == M": (("ffn H == M", ROWS, False, False, False, True), True),
    "CPU tensor": (("expertmlp", ROWS, False, False, False, False), False),
}


@pytest.mark.parametrize("case", list(QUALIFY))
def test_which_calls_qualify(case):
    (kind, rows, grad, train, noise, cuda), want = QUALIFY[case]
    fn = graphs.GraphedModelFn(None, _layer(kind), ROWS, graphs.GraphPool())
    # the rule reads the points' device and row count only
    pts = types.SimpleNamespace(is_cuda=cuda, shape=(rows, 7))
    sigma_noise = torch.zeros(rows, 1) if noise else None
    with torch.set_grad_enabled(grad):
        assert fn.qualifies(pts, sigma_noise, train) is want


def _points(model, n: int, seed: int, device) -> torch.Tensor:
    """n points of the width `model` takes: xyz (mip: mean and variance),
    a view direction, an appearance index."""
    g = torch.Generator().manual_seed(seed)
    xd = model.xyz_dim
    cols = [torch.rand(n, xd, generator=g) * 2 - 1]
    if getattr(model, "use_mip", False):
        cols.append(torch.rand(n, xd, generator=g) * 1e-3)
    if model.pos_dir_dim > 0:
        d = torch.randn(n, 3, generator=g)
        cols.append(d / torch.linalg.norm(d, dim=-1, keepdim=True))
    if model.appearance_dim > 0:
        cols.append(torch.randint(0, 8, (n, 1), generator=g).float())
    return torch.cat(cols, dim=-1).to(device)


def _building(device, nodrop=True, bg=False):
    h = building_eval_hparams()
    h.moe_test_batch = not nodrop
    make = get_bg_nerf if bg else get_nerf
    return make(h, 8, device=device, seed=0), h.model_chunk_size


def test_wrapped_model_fn_returns_the_plain_bits_on_the_cpu():
    model, _ = _building("cpu")
    plain = make_model_fn(model)
    fn = graphs.GraphedModelFn(plain, model, ROWS, graphs.GraphPool())
    with torch.no_grad():
        for rows in (ROWS, ROWS, ROWS, ROWS - 24):
            pts = _points(model, rows, rows, "cpu")
            got, want = fn(pts), plain(pts)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fn.entry is None


def test_eval_step_renders_the_plain_bits_on_the_cpu():
    """make_eval_step's graphed model functions against the plain ones in
    render_rays, over full chunks and a tail (rays x 768 samples in
    1,024-point chunks)."""
    h = building_eval_hparams()
    h.model_chunk_size = 1024
    model = get_nerf(h, 8, device="cpu", seed=0)
    bg = get_bg_nerf(h, 8, device="cpu", seed=1)
    cfg = render_config_from_hparams(h)
    scene = SceneInfo(torch.zeros(3), torch.ones(3))
    step = make_eval_step(model, bg, h, cfg, scene, device="cpu")
    batch = ray_batch(3, 0, "cpu")
    got = step(batch)
    with torch.no_grad():
        want = render_rays(make_model_fn_pair(model)[0],
                           make_model_fn_pair(bg)[0], batch["rays"],
                           batch["image_indices"], cfg, scene.sphere_center,
                           scene.sphere_radius, get_depth=True,
                           get_bg_fg_rgb=True)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_key_follows_the_weights_storage():
    """Weights changed in place keep the key; a parameter set anew (new
    storage) changes it; so do the points' shape and the fused dispatch."""
    layer = _layer("expertmlp")
    fn = graphs.GraphedModelFn(None, layer, ROWS, graphs.GraphPool())
    pts = torch.zeros(ROWS, 16)
    key = fn.key(pts)
    with torch.no_grad():
        layer.experts.w0.mul_(0.5)
    assert fn.key(pts) == key
    assert fn.key(torch.zeros(ROWS, 8)) != key
    layer.load_state_dict({k: v.clone() for k, v in
                           layer.state_dict().items()}, assign=True)
    moved = fn.key(pts)
    assert moved != key
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWITCH_NERF_FUSED_DISPATCH", "1")
        assert fn.key(pts) != moved


# ------------------------------------------------------------------ card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _models(name, dev):
    if name == "building no-drop bf16":
        return _building(dev)
    if name == "building padded":
        return _building(dev, nodrop=False)
    if name == "building background":
        return _building(dev, bg=True)
    h = mission_bay_train_hparams()                   # M = 512, no-drop
    return get_nerf(h, 8, device=dev, seed=0), 32768


class _Counted:
    """A model function that counts its eager runs (a replay runs none)."""

    def __init__(self, fn):
        self.fn, self.runs = fn, 0

    def __call__(self, *args):
        self.runs += 1
        return self.fn(*args)


def _graphed(model, rows):
    plain = make_model_fn(model)
    counted = _Counted(plain)
    return plain, counted, graphs.GraphedModelFn(counted, model, rows,
                                                 graphs.GraphPool())


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["building no-drop bf16", "building padded",
                                  "building background",
                                  "mission bay M = 512"])
@torch.no_grad()
def test_replay_gives_the_eager_bits_over_three_chunks(cuda, name):
    """Warm-up (eager), capture, then three chunks of other points replayed
    and held at once: each equals its eager call bit for bit, and the
    launch counters count each call's K1R once, the capturing call's
    too."""
    model, rows = _models(name, cuda)
    plain, counted, fn = _graphed(model, rows)
    start = ragged_chain.ragged_launches
    fn(_points(model, rows, 100, cuda))               # eager
    fn(_points(model, rows, 101, cuda))               # captured, replayed
    warm = ragged_chain.ragged_launches - start
    assert counted.runs == 2 and fn.entry is not None
    pts = [_points(model, rows, seed, cuda) for seed in range(3)]
    before = ragged_chain.ragged_launches
    outs = [fn(p) for p in pts]
    replayed = ragged_chain.ragged_launches - before
    assert counted.runs == 2
    before = ragged_chain.ragged_launches
    eager = [plain(p) for p in pts]
    assert replayed == ragged_chain.ragged_launches - before
    assert 3 * warm == 2 * replayed
    for got, want in zip(outs, eager):
        assert _equal(got, want)
    assert not _equal(outs[0], outs[1])


@pytest.mark.cuda
@torch.no_grad()
def test_replay_reads_weights_changed_in_place(cuda):
    model, rows = _building(cuda)
    plain, counted, fn = _graphed(model, rows)
    pts = _points(model, rows, 0, cuda)
    fn(pts)
    first = fn(pts)
    for p in model.parameters():
        p.mul_(0.75)
    got = fn(pts)
    assert counted.runs == 2
    assert _equal(got, plain(pts)) and not _equal(got, first)


@pytest.mark.cuda
@torch.no_grad()
def test_weights_on_new_storage_are_captured_anew(cuda):
    model, rows = _building(cuda)
    plain, counted, fn = _graphed(model, rows)
    pts = _points(model, rows, 0, cuda)
    fn(pts)
    fn(pts)
    old = fn.entry
    model.load_state_dict({k: v * 0.5 for k, v in
                           model.state_dict().items()}, assign=True)
    got = fn(pts)                        # a new key: eager first
    assert counted.runs == 3 and fn.entry is old
    assert _equal(got, plain(pts))
    got = fn(pts)                        # captured anew
    assert counted.runs == 4 and fn.entry is not old
    assert _equal(got, plain(pts))


@pytest.mark.cuda
@torch.no_grad()
def test_tail_chunk_runs_eagerly(cuda):
    model, rows = _building(cuda)
    plain, counted, fn = _graphed(model, rows)
    for seed in range(3):
        fn(_points(model, rows, seed, cuda))
    runs = counted.runs
    tail = _points(model, rows - 100, 7, cuda)
    assert _equal(fn(tail), plain(tail))
    assert counted.runs == runs + 1


@pytest.mark.cuda
@torch.no_grad()
def test_replayed_kernels_show_in_the_profiler_by_name(cuda):
    """A replay inside ``model.graph``, its kernels in the profiler's device
    list one by one: the eager call's kernels, by name and in order, and
    besides them only the graph's copy and fill nodes, which the profiler
    lists as kernels of their own (``memcpy32_post``, ``memset32``) where
    the eager call's are ``Memcpy`` and ``Memset`` operations. Each call
    runs in a range of its own, after a first call that the comparison
    leaves out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    model, rows = _building(cuda)
    plain, counted, fn = _graphed(model, rows)
    pts = _points(model, rows, 0, cuda)
    fn(pts)
    fn(pts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, call in (("first", plain), ("replay", fn),
                           ("eager", plain)):
            with record_function(f"case.{name}"):
                call(pts)
                torch.cuda.synchronize()
    events = prof.events()
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    cases = {e.name[len("case."):]: (e.time_range.start, e.time_range.end)
             for e in host if e.name.startswith("case.")}

    def inside(name, device):
        lo, hi = cases[name]
        return [e.name for e in sorted(events, key=lambda e: e.time_range.start)
                if (e.device_type == DeviceType.CUDA) == device
                # the device's mirrors of the host's ranges are no kernels
                and not (device and getattr(e, "is_user_annotation", False))
                and not e.name.startswith(("Memcpy", "Memset", "case."))
                and lo <= e.time_range.start <= hi]
    replayed, eager = inside("replay", True), inside("eager", True)
    assert "snerf.model.graph" in inside("replay", False)
    assert any("chain_fwd_sm90" in k for k in replayed)
    node = ("memcpy", "memset")
    print(f"{len(eager)} eager kernels; the replay's copy and fill nodes: "
          f"{dict(Counter(k for k in replayed if k.startswith(node)))}")
    assert [k for k in replayed if not k.startswith(node)] == eager
