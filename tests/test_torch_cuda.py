"""The port's Hopper kernels against their plain PyTorch versions, on the card,
forward (K1, K3, K1R) and backward (K2, K4, K2R, the embedding's), the
gradients of a training forward on the card, and the no-drop MoE layer
(K1R/K2R) against the padded one (K1/K2) at a capacity that drops nothing. The edge cases (C across the tile edge, one expert,
views at an offset, the layer limit, determinism) run for K1/K2 ("chain")
and for K3/K4 ("fused", over a slot map with empty slots), which share one
mainloop and differ in how the input tile arrives.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. This file imports no JAX, so on a machine with a card (and no JAX)
it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: fp32 max |kernel - plain| <= 1e-4 (fp32 sums in another order;
dW and db relative to their largest entry, which sums C products); bf16
max |kernel - plain| <= 2e-2 * max |plain| (bf16 rounding at each layer,
where a 1-ulp flip moves later layers).
"""
import pytest
import torch

from switch_nerf_torch.models.moe import MoELayer
from switch_nerf_torch.ops import expert_kernel, fused_dispatch, ragged_chain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chain_weights(e, m, layers, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    bound = m ** -0.5
    ws = (torch.rand(layers, e, m, m, generator=g) * 2 - 1) * bound
    bs = (torch.rand(layers, e, 1, m, generator=g) * 2 - 1) * bound
    return ws.to(device, dtype), bs.to(device, dtype)


def _assert_close(out, ref, dtype, rel=False):
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * (scale if rel else 1.0), err
    else:
        assert err <= 2e-2 * scale, err


def _assert_bwd_close(out, ref, dtype):
    """(dx, dW, db) of a kernel vs the plain backward."""
    assert out[1].dtype == out[2].dtype == torch.float32
    for o, r, rel in zip(out, ref, (False, True, True)):
        _assert_close(o, r, dtype, rel)


def _slot_map(s, e, cap, g, device):
    """A slot map with empty slots (-> the zero row s) and unused tokens."""
    stt = torch.randint(0, s, (e * cap,), generator=g)
    stt[torch.rand(e * cap, generator=g) < 0.3] = s
    return stt.to(device, torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,skips", [
    (1, ()), (3, (1,)), (4, (1, 3)), (3, (2,)), (7, (3,))])
@pytest.mark.parametrize("m", [64, 128, 256])
def test_expert_chain_kernel_matches_plain(cuda, m, layers, skips, dtype):
    e, c = 3, 200                      # ragged C: not a multiple of a block
    ws, bs = _chain_weights(e, m, layers, dtype, cuda, seed=m + layers)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(e, c, m, generator=g).to(cuda, dtype)
    before = expert_kernel.launches
    out = expert_kernel.expert_mlp_chain(x, ws, bs, skips)
    torch.cuda.synchronize()
    assert expert_kernel.launches == before + 1
    _assert_close(out, expert_kernel.expert_mlp_chain_plain(x, ws, bs, skips),
                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [128, 256])
def test_fused_dispatch_kernel_matches_plain(cuda, m, dtype):
    e, cap, s, layers, skips = 4, 96, 300, 3, (1,)
    ws, bs = _chain_weights(e, m, layers, dtype, cuda, seed=m)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randn(s, m, generator=g)
    tokens_ext = torch.cat([tokens, torch.zeros(1, m)]).to(cuda, dtype)
    stt = _slot_map(s, e, cap, g, cuda)
    before = fused_dispatch.launches
    out = fused_dispatch.fused_dispatch_chain_fwd(tokens_ext, stt, ws, bs,
                                                  skips)
    torch.cuda.synchronize()
    assert fused_dispatch.launches == before + 1
    ref = fused_dispatch.fused_dispatch_chain_plain(tokens_ext, stt, ws, bs,
                                                    skips)
    _assert_close(out, ref, dtype)


def test_kernel_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    ws, bs = _chain_weights(2, 128, 2, torch.float32, cuda, seed=0)
    x = torch.randn(2, 40, 128, device=cuda)
    with pytest.raises(ValueError):
        expert_kernel.expert_mlp_chain(x.transpose(0, 1).contiguous()
                                       .transpose(0, 1), ws, bs)
    with pytest.raises(TypeError):
        expert_kernel.expert_mlp_chain(x.half(), ws.half(), bs.half())
    w96, b96 = _chain_weights(2, 96, 2, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError):
        expert_kernel.expert_mlp_chain(torch.randn(2, 40, 96, device=cuda),
                                       w96, b96)
    with pytest.raises(ValueError):
        fused_dispatch.fused_dispatch_chain_fwd(
            torch.randn(41, 128, device=cuda),
            torch.zeros(80, dtype=torch.int64, device=cuda), ws, bs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,skips", [
    (1, ()), (3, (1,)), (4, (1, 3)), (3, (2,)), (7, (3,))])
@pytest.mark.parametrize("m", [64, 128, 256])
def test_expert_chain_bwd_kernel_matches_plain(cuda, m, layers, skips, dtype):
    """K2 vs expert_mlp_chain_bwd_plain over K1's grid, ragged C."""
    e, c = 3, 200
    ws, bs = _chain_weights(e, m, layers, dtype, cuda, seed=m + layers)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(e, c, m, generator=g).to(cuda, dtype)
    gy = torch.randn(e, c, m, generator=g).to(cuda, dtype)
    before = expert_kernel.bwd_launches
    out = expert_kernel.expert_mlp_chain_bwd(x, ws, bs, gy, skips)
    torch.cuda.synchronize()
    assert expert_kernel.bwd_launches == before + 1
    assert out[0].dtype == dtype
    _assert_bwd_close(out, expert_kernel.expert_mlp_chain_bwd_plain(
        x, ws, bs, gy, skips), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [128, 256])
def test_fused_dispatch_bwd_kernel_matches_plain(cuda, m, dtype):
    e, cap, s, layers, skips = 4, 96, 300, 3, (1,)
    ws, bs = _chain_weights(e, m, layers, dtype, cuda, seed=m + 1)
    g = torch.Generator().manual_seed(4)
    tokens_ext = torch.cat([torch.randn(s, m, generator=g),
                            torch.zeros(1, m)]).to(cuda, dtype)
    stt = _slot_map(s, e, cap, g, cuda)
    gy = torch.randn(e, cap, m, generator=g).to(cuda, dtype)
    before = fused_dispatch.bwd_launches
    out = fused_dispatch.fused_dispatch_chain_bwd(tokens_ext, stt, ws, bs, gy,
                                                  skips)
    torch.cuda.synchronize()
    assert fused_dispatch.bwd_launches == before + 1
    _assert_bwd_close(out, fused_dispatch.fused_dispatch_chain_bwd_plain(
        tokens_ext, stt, ws, bs, gy, skips), dtype)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_cuda_training_forward_gives_every_expert_weight_a_gradient(
        cuda, monkeypatch, fused):
    """A MoE layer's forward on the card with grad enabled: every expert
    weight and bias, the gate and the input get a non-zero gradient, through
    K2 (K4 when fused). (Without the autograd Functions the kernels' outputs
    carried no gradient at all.)"""
    from switch_nerf_torch.models.moe import MoELayer
    monkeypatch.setenv("SWITCH_NERF_FUSED_DISPATCH", fused)
    torch.manual_seed(0)
    layer = MoELayer(model_dim=128, num_experts=4, layer_num=3, skips=(1,),
                     capacity_factor=1.0, batch_prioritized_routing=True,
                     generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.randn(512, 128, device=cuda, requires_grad=True)
    counts = (expert_kernel.bwd_launches, fused_dispatch.bwd_launches)
    y, l_aux, _ = layer(x, train=True)
    (y.square().sum() + l_aux).backward()
    torch.cuda.synchronize()
    ran = (expert_kernel.bwd_launches - counts[0],
           fused_dispatch.bwd_launches - counts[1])
    assert ran == ((0, 1) if fused == "1" else (1, 0))
    assert x.grad is not None and x.grad.abs().max() > 0
    for name, p in layer.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name


def test_bwd_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    ws, bs = _chain_weights(2, 128, 2, torch.float32, cuda, seed=0)
    x = torch.randn(2, 40, 128, device=cuda)
    with pytest.raises(ValueError):                      # g of another shape
        expert_kernel.expert_mlp_chain_bwd(x, ws, bs, x[:, :20].contiguous())
    with pytest.raises(ValueError):                      # g of another dtype
        expert_kernel.expert_mlp_chain_bwd(x, ws, bs, x.bfloat16())
    with pytest.raises(ValueError):                      # strided g
        expert_kernel.expert_mlp_chain_bwd(
            x, ws, bs, x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(TypeError):
        expert_kernel.expert_mlp_chain_bwd(x.half(), ws.half(), bs.half(),
                                           x.half())
    with pytest.raises(ValueError):                      # C == 0
        expert_kernel.expert_mlp_chain_bwd(x[:, :0], ws, bs, x[:, :0])
    with pytest.raises(ValueError):                      # int64 slot map
        fused_dispatch.fused_dispatch_chain_bwd(
            torch.randn(41, 128, device=cuda),
            torch.zeros(80, dtype=torch.int64, device=cuda), ws, bs,
            torch.randn(2, 40, 128, device=cuda))


def _chain_case(e, c, m, layers, dtype, device, seed):
    ws, bs = _chain_weights(e, m, layers, dtype, device, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(e, c, m, generator=g).to(device, dtype)
    gy = torch.randn(e, c, m, generator=g).to(device, dtype)
    return x, ws, bs, gy


def _check_fwd_bwd(x, ws, bs, gy, skips, dtype):
    _assert_close(expert_kernel.expert_mlp_chain(x, ws, bs, skips),
                  expert_kernel.expert_mlp_chain_plain(x, ws, bs, skips),
                  dtype)
    _assert_bwd_close(
        expert_kernel.expert_mlp_chain_bwd(x, ws, bs, gy, skips),
        expert_kernel.expert_mlp_chain_bwd_plain(x, ws, bs, gy, skips), dtype)


def _check_fused_fwd_bwd(tokens_ext, stt, ws, bs, gy, skips, dtype):
    fwd = (fused_dispatch.launches, fused_dispatch.bwd_launches)
    _assert_close(
        fused_dispatch.fused_dispatch_chain_fwd(tokens_ext, stt, ws, bs,
                                                skips),
        fused_dispatch.fused_dispatch_chain_plain(tokens_ext, stt, ws, bs,
                                                  skips), dtype)
    _assert_bwd_close(
        fused_dispatch.fused_dispatch_chain_bwd(tokens_ext, stt, ws, bs, gy,
                                                skips),
        fused_dispatch.fused_dispatch_chain_bwd_plain(tokens_ext, stt, ws, bs,
                                                      gy, skips), dtype)
    assert (fused_dispatch.launches, fused_dispatch.bwd_launches) == (
        fwd[0] + 1, fwd[1] + 1)


def _fused_case(x, seed):
    """K3/K4's inputs from a chain case's x [E, C, M]: its E*C rows as the
    tokens plus the zero row, and a slot map with empty slots."""
    e, c, m = x.shape
    tokens_ext = torch.cat([x.reshape(-1, m), x.new_zeros((1, m))])
    stt = _slot_map(e * c, e, c, torch.Generator().manual_seed(seed),
                    x.device)
    return tokens_ext, stt


def _check_case(kernels, e, c, m, layers, dtype, device, seed, skips):
    """K1 and K2 ("chain") or K3 and K4 ("fused") against their plain
    versions on one seeded case."""
    x, ws, bs, gy = _chain_case(e, c, m, layers, dtype, device, seed=seed)
    if kernels == "chain":
        _check_fwd_bwd(x, ws, bs, gy, skips, dtype)
    else:
        tokens_ext, stt = _fused_case(x, seed + 2)
        _check_fused_fwd_bwd(tokens_ext, stt, ws, bs, gy, skips, dtype)


KERNELS = ["chain", "fused"]


@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("m", [64, 256])
@pytest.mark.parametrize("c", [1, 63, 64, 127, 128, 129, 4096])
def test_chain_kernels_across_the_tile_edge(cuda, c, m, kernels):
    """K1/K2 and K3/K4 in bf16 where C ends inside, at and just past a
    64-row TMA box and the 128-row tile: rows past C are zero-filled on load
    (K3/K4: by cp.async) and clipped on store."""
    _check_case(kernels, 2, c, m, 3, torch.bfloat16, cuda, seed=c, skips=(1,))


@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_kernels_single_expert(cuda, dtype, kernels):
    _check_case(kernels, 1, 300, 128, 4, dtype, cuda, seed=5, skips=(2,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [64, 256])
def test_fused_kernels_with_every_slot_empty(cuda, m, dtype):
    """K3/K4 when every slot points at the zero row: the chain runs on
    zeros, as over an empty dispatch buffer."""
    x, ws, bs, gy = _chain_case(3, 200, m, 4, dtype, cuda, seed=m + 19)
    tokens_ext = torch.cat([x[0], x.new_zeros((1, m))])
    stt = torch.full((3 * 200,), 200, dtype=torch.int32, device=cuda)
    _check_fused_fwd_bwd(tokens_ext, stt, ws, bs, gy, (1,), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [64, 128, 256])
def test_chain_kernels_skip_at_first_and_last_layer(cuda, m, dtype):
    x, ws, bs, gy = _chain_case(3, 200, m, 4, dtype, cuda, seed=m + 7)
    _check_fwd_bwd(x, ws, bs, gy, (0, 3), dtype)


@pytest.mark.parametrize("kernels", KERNELS)
def test_chain_bwd_kernel_at_its_layer_limit(cuda, kernels):
    """bf16 M=256 holds 8 layers of ReLU masks in shared memory; a ninth
    layer is refused (K2, and K4, which inherits K2's pass 1)."""
    limit = expert_kernel.bwd_max_layers(cuda, 256, torch.bfloat16)
    assert limit == 8
    x, ws, bs, gy = _chain_case(2, 150, 256, limit, torch.bfloat16, cuda,
                                seed=11)
    w9, b9 = _chain_weights(2, 256, limit + 1, torch.bfloat16, cuda, seed=0)
    if kernels == "chain":
        _check_fwd_bwd(x, ws, bs, gy, (3,), torch.bfloat16)
        with pytest.raises(ValueError):
            expert_kernel.expert_mlp_chain_bwd(x, w9, b9, gy)
    else:
        tokens_ext, stt = _fused_case(x, 12)
        _check_fused_fwd_bwd(tokens_ext, stt, ws, bs, gy, (3,),
                             torch.bfloat16)
        with pytest.raises(ValueError):
            fused_dispatch.fused_dispatch_chain_bwd(tokens_ext, stt, w9, b9,
                                                    gy)


@pytest.mark.parametrize("kernels", KERNELS)
def test_chain_bwd_kernel_is_deterministic(cuda, kernels):
    """K2's (K4's) dx, dW and db are bit-identical across launches
    (fixed-order sums, no atomics)."""
    x, ws, bs, gy = _chain_case(4, 1000, 256, 7, torch.bfloat16, cuda,
                                seed=13)
    if kernels == "chain":
        def run():
            return expert_kernel.expert_mlp_chain_bwd(x, ws, bs, gy, (3,))
    else:
        tokens_ext, stt = _fused_case(x, 14)

        def run():
            return fused_dispatch.fused_dispatch_chain_bwd(
                tokens_ext, stt, ws, bs, gy, (3,))
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_kernels_on_views_at_an_offset(cuda, dtype, kernels):
    """Inputs that are views 16 bytes into a larger buffer: the tensor maps'
    base (K3/K4: the gather's token rows) is not the start of an
    allocation."""
    e, c, m, layers = 2, 130, 128, 3
    _, ws, bs, _ = _chain_case(e, c, m, layers, dtype, cuda, seed=17)
    g = torch.Generator().manual_seed(18)
    shift = 16 // torch.empty((), dtype=dtype).element_size()
    n = e * c * m
    bufs = [torch.randn(n + m + 2 * shift, generator=g).to(cuda, dtype)
            for _ in range(2)]
    x, gy = (b[shift:shift + n].view(e, c, m) for b in bufs)
    assert x.data_ptr() % 16 == 0 and x.data_ptr() % 256 != 0
    if kernels == "chain":
        _check_fwd_bwd(x, ws, bs, gy, (1,), dtype)
    else:
        tokens_ext = bufs[0][shift:shift + n + m].view(e * c + 1, m)
        tokens_ext[-1] = 0
        stt = _slot_map(e * c, e, c, g, cuda)
        _check_fused_fwd_bwd(tokens_ext, stt, ws, bs, gy, (1,), dtype)


# ---------------------------------------------------------- K1R, K2R ----

def _dirty_allocator(device, nbytes=1 << 28):
    """Leave NaN bytes in the caching allocator's free blocks, so a kernel
    output that is allocated with torch.empty and not written shows."""
    torch.full((nbytes // 4,), float("nan"), device=device)
    torch.cuda.synchronize()


def _ragged_case(counts, m, layers, dtype, device, seed):
    e, n = len(counts), sum(counts)
    ws, bs = _chain_weights(e, m, layers, dtype, device, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(n, m, generator=g).to(device, dtype)
    gy = torch.randn(n, m, generator=g).to(device, dtype)
    cnt = torch.tensor(counts, dtype=torch.int32, device=device)
    return x, cnt, ws, bs, gy


def _check_ragged(counts, m, layers, skips, dtype, device, seed):
    """K1R and K2R against their plain versions: each launched once, dW and
    db of every empty expert exactly zero (over NaN-filled memory)."""
    x, cnt, ws, bs, gy = _ragged_case(counts, m, layers, dtype, device, seed)
    before = (ragged_chain.ragged_launches, ragged_chain.ragged_bwd_launches)
    _dirty_allocator(device)
    out = ragged_chain.ragged_chain_fwd(x, cnt, ws, bs, skips)
    _assert_close(out, ragged_chain.ragged_chain_plain(x, cnt, ws, bs, skips),
                  dtype)
    _dirty_allocator(device)
    got = ragged_chain.ragged_chain_bwd(x, cnt, ws, bs, gy, skips)
    torch.cuda.synchronize()
    _assert_bwd_close(got, ragged_chain.ragged_chain_bwd_plain(
        x, cnt, ws, bs, gy, skips), dtype)
    assert (ragged_chain.ragged_launches,
            ragged_chain.ragged_bwd_launches) == (before[0] + 1, before[1] + 1)
    for e, c in enumerate(counts):
        if c == 0:
            assert not got[1][:, e].any() and not got[2][:, e].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layers,skips", [(1, ()), (4, (1, 3)), (7, (3,))])
@pytest.mark.parametrize("m", [64, 128, 256])
def test_ragged_chain_kernels_match_plain(cuda, m, layers, skips, dtype):
    """Skewed counts: an empty expert, counts off the 32- and 128-row
    blocks, one expert with most rows."""
    _check_ragged([0, 200, 37, 1500, 129], m, layers, skips, dtype, cuda,
                  seed=m + layers)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts", [
    [1], [0, 0, 5], [128, 128], [64, 0, 63, 65], [0, 4096, 0], [3000, 1]])
def test_ragged_chain_kernels_edge_counts(cuda, counts, dtype):
    """One row, all rows in one expert, counts at, below and past the tile
    and box edges, empty experts first and last."""
    _check_ragged(counts, 256, 3, (1,), dtype, cuda, seed=sum(counts))


# K2R's dW pass cuts each expert's rows into chunks of this many rows
# (csrc/rows.cuh kChunkRows) and reduces the chunks' partial sums.
_CHUNK_ROWS = 2048


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [64, 128, 256])
@pytest.mark.parametrize("counts", [
    [0, _CHUNK_ROWS, 0, _CHUNK_ROWS - 1, _CHUNK_ROWS + 1, 0],
    [0, 0, 4 * _CHUNK_ROWS + 77, 0],
    [2 * _CHUNK_ROWS + 1, 0, 3 * _CHUNK_ROWS]])
def test_ragged_chain_kernels_across_the_row_chunks(cuda, counts, m, dtype):
    """The dW pass's row split: an expert of exactly one chunk, one row
    short of it and one past it; all rows in one expert over five chunks
    (several partials reduce); two experts of several chunks each; empty
    experts first, in the middle and last."""
    _check_ragged(counts, m, 3, (1,), dtype, cuda, seed=m + sum(counts))


def test_ragged_kernels_need_no_host_sync(cuda):
    """K1R and K2R launch under sync debug mode "error": the counts stay on
    the card, and no wrapper or workspace waits for the device."""
    for dtype in (torch.float32, torch.bfloat16):
        x, cnt, ws, bs, gy = _ragged_case([0, 3001, 4100, 899], 256, 7,
                                          dtype, cuda, seed=31)
        ragged_chain.ragged_chain_fwd(x, cnt, ws, bs, (3,))   # built, loaded
        ragged_chain.ragged_chain_bwd(x, cnt, ws, bs, gy, (3,))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ragged_chain.ragged_chain_fwd(x, cnt, ws, bs, (3,))
            ragged_chain.ragged_chain_bwd(x, cnt, ws, bs, gy, (3,))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def test_ragged_fp32_kernels_error_against_float64(cuda):
    """At Bungee's layer (M256 L7 skip 3, E4, skewed counts) the 3xTF32
    kernels' largest error against a float64 run of the plain chain is at
    most 4x the plain fp32 chain's own: split precision keeps fp32's
    accuracy (one TF32 product would not)."""
    _ragged_error_against_float64([0, 301, 2900, 895], 256, cuda, seed=41)


def _ragged_error_against_float64(counts, m, cuda, seed):
    skips = (3,)
    x, cnt, ws, bs, gy = _ragged_case(counts, m, 7, torch.float32, cuda,
                                      seed=seed)
    wide = [t.double().requires_grad_() for t in (x, ws, bs)]
    ref = ragged_chain.ragged_chain_plain(wide[0], cnt, wide[1], wide[2],
                                          skips)
    ref_b = torch.autograd.grad(ref, wide, gy.double())
    ref = ref.detach()

    def errs(out, want):
        return [((o.double() - w).abs().max() / w.abs().max()).item()
                for o, w in zip(out, want)]
    kernel = errs([ragged_chain.ragged_chain_fwd(x, cnt, ws, bs, skips)]
                  + list(ragged_chain.ragged_chain_bwd(x, cnt, ws, bs, gy,
                                                       skips)),
                  [ref] + list(ref_b))
    plain = errs([ragged_chain.ragged_chain_plain(x, cnt, ws, bs, skips)]
                 + list(ragged_chain.ragged_chain_bwd_plain(x, cnt, ws, bs,
                                                            gy, skips)),
                 [ref] + list(ref_b))
    for name, k, p in zip(("out", "dx", "dW", "db"), kernel, plain):
        assert k <= 4 * p, (name, k, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_bwd_kernel_is_deterministic(cuda, dtype):
    x, cnt, ws, bs, gy = _ragged_case([700, 0, 3000, 397], 256, 7,
                                      dtype, cuda, seed=21)
    first = ragged_chain.ragged_chain_bwd(x, cnt, ws, bs, gy, (3,))
    second = ragged_chain.ragged_chain_bwd(x, cnt, ws, bs, gy, (3,))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_ragged_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    x, cnt, ws, bs, gy = _ragged_case([10, 20], 128, 2, torch.float32, cuda,
                                      seed=3)
    with pytest.raises(ValueError):     # counts not int32
        ragged_chain.ragged_chain_fwd(x, cnt.long(), ws, bs)
    with pytest.raises(ValueError):     # counts of another expert count
        ragged_chain.ragged_chain_fwd(x, cnt[:1], ws, bs)
    with pytest.raises(ValueError):     # x not [N, M]
        ragged_chain.ragged_chain_fwd(x[None], cnt, ws, bs)
    with pytest.raises(TypeError):      # dtype mismatch
        ragged_chain.ragged_chain_fwd(x.bfloat16(), cnt, ws, bs)


def _moe_pair(e, m, dtype, device, seed):
    """Two MoE layers with the same weights at capacity factor E (padded
    dispatch then drops nothing): one padded, one no-drop."""
    layers = []
    for mode in ("padded", "nodrop"):
        layer = MoELayer(m, e, layer_num=4, skips=(2,), capacity_factor=e,
                         batch_prioritized_routing=True, train_dispatch=mode,
                         eval_dispatch=mode,
                         generator=torch.Generator().manual_seed(seed))
        layers.append(layer.to(device))
    return layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nodrop_moe_matches_padded_at_full_capacity(cuda, dtype):
    """K1R/K2R's no-drop layer equals K1/K2's padded layer where padding
    drops nothing: outputs and every gradient, fp32 within 1e-5 (sums in
    another order), bf16 within the bf16 rule."""
    e, m, s = 4, 128, 3000
    padded, nodrop = _moe_pair(e, m, dtype, cuda, seed=5)
    g = torch.Generator().manual_seed(6)
    x0 = torch.randn(s, m, generator=g).to(cuda)
    gy = torch.randn(s, m, generator=g).to(cuda, dtype)
    outs, grads = [], []
    for layer in (padded, nodrop):
        x = x0.clone().to(dtype).requires_grad_(True)
        y, _, _ = layer(x, train=True)
        params = [x] + list(layer.parameters())
        grads.append(torch.autograd.grad(y, params, gy))
        outs.append(y.detach())
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (outs[1].float() - outs[0].float()).abs().max() <= \
        tol * max(1.0, outs[0].float().abs().max().item())
    for a, b in zip(*grads):
        scale = a.float().abs().max().item()
        assert (b.float() - a.float()).abs().max() <= tol * max(scale, 1e-6)


# Mission Bay's trunk is 512 wide: the bf16 kernels run 64-row tiles there,
# each consumer warpgroup on half the columns, and K2's dW pass 128 x 256
# tiles (csrc/chain_sm90.cuh Cfg::kSplit, chain_bwd_sm90.cuh DwCfg::kTN).
@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("c", [1, 63, 64, 65, 200, 4096])
def test_wide_chain_kernels_match_plain(cuda, c, kernels):
    """K1/K2 and K3/K4 in bf16 at M = 512, 7 layers, skip 3 (Mission Bay's
    expert chain), where C ends inside, at and past the 64-row tile."""
    _check_case(kernels, 2, c, 512, 7, torch.bfloat16, cuda, seed=c + 512,
                skips=(3,))


@pytest.mark.parametrize("skips", [(0, 3), (1, 2)])
def test_wide_chain_kernels_skip_layers(cuda, skips):
    x, ws, bs, gy = _chain_case(3, 300, 512, 4, torch.bfloat16, cuda,
                                seed=sum(skips) + 31)
    _check_fwd_bwd(x, ws, bs, gy, skips, torch.bfloat16)


def test_wide_bwd_kernel_layer_limit_and_determinism(cuda):
    """At M = 512 pass 1 holds the ReLU masks of 6 layers: 7 layers run
    (Mission Bay's chain), bit-identical twice; an eighth is refused."""
    limit = expert_kernel.bwd_max_layers(cuda, 512, torch.bfloat16)
    assert limit == 7
    x, ws, bs, gy = _chain_case(4, 1000, 512, limit, torch.bfloat16, cuda,
                                seed=41)
    first = expert_kernel.expert_mlp_chain_bwd(x, ws, bs, gy, (3,))
    second = expert_kernel.expert_mlp_chain_bwd(x, ws, bs, gy, (3,))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    w8, b8 = _chain_weights(4, 512, limit + 1, torch.bfloat16, cuda, seed=0)
    with pytest.raises(ValueError):
        expert_kernel.expert_mlp_chain_bwd(x, w8, b8, gy)


@pytest.mark.parametrize("counts", [
    [0, 200, 37, 1500, 129], [64, 0, 63, 65], [1],
    [0, _CHUNK_ROWS + 1, 0, 2 * _CHUNK_ROWS - 1]])
def test_wide_ragged_chain_kernels_match_plain(cuda, counts):
    """K1R and K2R in bf16 at M = 512, 7 layers: an empty expert, counts off
    the 64-row tiles and across the dW pass's row chunks."""
    _check_ragged(counts, 512, 7, (3,), torch.bfloat16, cuda,
                  seed=512 + sum(counts))


def test_wide_float32_kernels_refuse(cuda):
    """fp32 at M = 512 (Mission Bay under --no_amp), once refused by every
    wrapper: K1-K4 and K1R/K2R (3xTF32, four column passes a layer) now
    take it and match their plain versions at
    Mission Bay's depth (7 layers, skip 3); K2, K4 and K2R repeat bit for
    bit; the backward limits are 32 layers (K2, K4) and 9 (K2R)."""
    f32 = torch.float32
    for c in (1, 33, 200):
        _check_case("chain", 2, c, 512, 7, f32, cuda, seed=c, skips=(3,))
        _check_case("fused", 2, c, 512, 7, f32, cuda, seed=c + 1,
                    skips=(3,))
    _check_ragged([0, 200, 37, 1500, 129], 512, 7, (3,), f32, cuda, seed=5)
    _check_ragged([64, 0, 63, 65, _CHUNK_ROWS + 1], 512, 7, (3,), f32, cuda,
                  seed=6)
    assert expert_kernel.bwd_max_layers(cuda, 512, f32) == 32
    x, ws, bs, gy = _chain_case(3, 300, 512, 7, f32, cuda, seed=7)
    tokens_ext, stt = _fused_case(x, 9)
    xr, cnt, wr, br, gr = _ragged_case([700, 0, 3000, 397], 512, 7, f32,
                                       cuda, seed=8)
    for call in (
            lambda: expert_kernel.expert_mlp_chain_bwd(x, ws, bs, gy, (3,)),
            lambda: fused_dispatch.fused_dispatch_chain_bwd(
                tokens_ext, stt, ws, bs, gy, (3,)),
            lambda: ragged_chain.ragged_chain_bwd(xr, cnt, wr, br, gr,
                                                  (3,))):
        first, second = call(), call()
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)
    w10, b10 = _chain_weights(4, 512, 10, f32, cuda, seed=0)
    ragged_chain.ragged_chain_bwd(xr, cnt, w10[:9], b10[:9], gr, (3,))
    with pytest.raises(ValueError, match="up to 9 layers"):
        ragged_chain.ragged_chain_bwd(xr, cnt, w10, b10, gr, (3,))


def test_wide_ragged_fp32_kernels_error_against_float64(cuda):
    """At Mission Bay's fp32 layer (M512 L7 skip 3, E8, skewed counts) the
    four-pass 3xTF32 kernels' largest error against a float64 run is at most
    4x the plain fp32 chain's, as at M = 256."""
    _ragged_error_against_float64(
        [0, 301, 2900, 895, 0, 1, 4000, 97], 512, cuda, seed=43)


def _embedding_case(layout, rows, num, feats, seed):
    """Indices [rows] int64 in one of EMBEDDING_CASES' layouts and a
    gradient [rows, feats] (a slice of a wider tensor for "strided", at a
    4-byte offset for "offset"), on the CPU."""
    g = torch.Generator().manual_seed(seed)
    if layout in ("runs", "strided", "offset", "wide table"):
        # a chunk of rays of 512 samples each, a random table row a ray
        idx = torch.randint(0, num, (-(-rows // 512),), generator=g)
        idx = idx.repeat_interleave(512)[:rows]
    elif layout == "unsorted":
        idx = torch.randint(0, num, (rows,), generator=g)
        idx[: rows // 3] = num // 2            # one table row takes many
        idx = idx[torch.randperm(rows, generator=g)]
    elif layout == "one index":
        idx = torch.full((rows,), num // 3, dtype=torch.long)
    elif layout == "alternating":               # every row its own run
        idx = torch.arange(rows) % 2 * (num - 1) // 2 + 1
    elif layout == "ends":
        idx = torch.randint(0, 2, (rows,), generator=g) * (num - 1)
    else:
        raise ValueError(layout)
    pad = {"strided": (0, 16), "offset": (1, 2)}.get(layout, (0, 0))
    wide = torch.randn(rows, feats + pad[1], generator=g) * 10
    return idx, wide[:, pad[0]:pad[0] + feats]


# (layout, rows, table rows, features): chip_smoke.py's 4a chunk (64 rays x
# 512 samples over Building's table), other orders, counts past shared
# memory (65,536 table rows), F from 1 to 8,192, one row and none
EMBEDDING_CASES = [
    ("runs", 32768, 1920, 48), ("unsorted", 32768, 1920, 48),
    ("one index", 32768, 1920, 48), ("alternating", 32768, 1920, 48),
    ("ends", 32768, 1920, 48), ("wide table", 32768, 65536, 48),
    ("runs", 32768, 1920, 1), ("runs", 32768, 1920, 5),
    ("runs", 32768, 1920, 300), ("runs", 4096, 1920, 8192),
    ("strided", 32768, 1920, 48), ("offset", 32768, 1920, 48),
    ("unsorted", 777, 9, 48), ("runs", 1, 4, 5), ("runs", 0, 4, 5),
    ("unsorted", 5000, 3, 300)]


@pytest.mark.parametrize("layout,rows,num,feats", EMBEDDING_CASES)
def test_embedding_bwd_kernel_matches_plain_bit_for_bit(cuda, layout, rows,
                                                        num, feats):
    """The embedding backward's kernel and its plain version (a CPU
    index_add_) give the same bits, and two calls (over NaN-filled memory)
    give the same bits, one launch counted a call; the table rows no index
    names come out 0."""
    from switch_nerf_torch.ops import embedding
    idx, gy = _embedding_case(layout, rows, num, feats, seed=rows + feats)
    want = embedding.embedding_bwd_plain(idx, gy, num)
    got = []
    for _ in range(2):
        _dirty_allocator(cuda)
        before = embedding.launches
        got.append(embedding.embedding_bwd(idx.to(cuda), gy.to(cuda), num))
        torch.cuda.synchronize()
        assert embedding.launches == before + 1
    assert got[0].shape == (num, feats)
    assert torch.equal(got[0].cpu(), want), (layout, rows, num, feats)
    assert torch.equal(got[0], got[1])


def test_embedding_bwd_runs_two_kernels_and_no_sort(cuda):
    """At chip_smoke.py's 4a chunk a call runs at most two device kernels,
    none of them a library sort (the grouping pass is hand-written)."""
    from torch.profiler import ProfilerActivity, profile
    from switch_nerf_torch.ops import embedding
    idx, gy = _embedding_case("runs", 32768, 1920, 48, seed=5)
    idx, gy = idx.to(cuda), gy.contiguous().to(cuda)
    embedding.embedding_bwd(idx, gy, 1920)             # build and load
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        embedding.embedding_bwd(idx, gy, 1920)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    names = [ev.key for ev in kernels]
    assert 0 < sum(ev.count for ev in kernels) <= 2, names
    assert not any("sort" in n.lower() or "radix" in n.lower()
                   for n in names), names
    assert any("embedding_bwd_group" in n for n in names), names
    assert any("embedding_bwd_sum" in n for n in names), names


SURFACE = {
    "top2_padded": dict(top_k=2),
    "top2_nodrop": dict(top_k=2, train_dispatch="nodrop"),
    "residual": dict(use_residual=True),
    "ffn_square": dict(expert_type="ffn", ffn_hidden_size=128),
    "ffn_wide": dict(expert_type="ffn", ffn_hidden_size=256),
}


@pytest.mark.parametrize("case", list(SURFACE))
def test_moe_surface_on_the_card_matches_the_cpu(cuda, case):
    """Top-2 (padded: K1/K2 at C = 2 cf S / E; no-drop: K1R/K2R over 2 S
    rows), the residual expert (K1/K2 at E = 1), ffn at H == M (the L2
    chain kernels) and H != M (batched products) in fp32: the layer on the
    card against the same layer on the CPU (the plain versions), output
    and every gradient within 1e-4 of the largest entry."""
    e, m, s = 4, 128, 3000
    kw = dict(model_dim=m, num_experts=e, layer_num=3, skips=(1,),
              batch_prioritized_routing=True, **SURFACE[case])
    cpu_layer = MoELayer(generator=torch.Generator().manual_seed(3), **kw)
    card_layer = MoELayer(**kw).to(cuda)
    card_layer.load_state_dict(cpu_layer.state_dict())
    g = torch.Generator().manual_seed(4)
    x0 = torch.randn(s, m, generator=g)
    gy = torch.randn(s, m, generator=g)
    got = []
    for layer, dev in ((card_layer, cuda), (cpu_layer, "cpu")):
        x = x0.to(dev).requires_grad_(True)
        y, l_aux, _ = layer(x, train=True)
        params = [x] + list(layer.parameters())
        grads = torch.autograd.grad((y * gy.to(dev)).sum() + l_aux, params)
        got.append([y.detach().cpu()] + [t.cpu() for t in grads])
    for a, b in zip(*got):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * max(scale, 1e-6)


# ------------------------------------------------- fp32 K2/K4, 3xTF32 ----
# fp32 K2 and K4 run K2R's design (csrc/chain_tf32.cuh, kInPlace / kGather):
# 64-row tiles, the dW pass over 2,048-row chunks of each expert, the masks
# read back from the recompute's hsave (so 32 layers at every width).

@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("m", [64, 128, 256, 512])
@pytest.mark.parametrize("c", [1, 63, 64, 65, _CHUNK_ROWS - 1, _CHUNK_ROWS,
                               _CHUNK_ROWS + 1])
def test_fp32_bwd_kernels_across_the_tile_and_chunk_edges(cuda, c, m,
                                                          kernels):
    """fp32 K1/K2 and K3/K4 where C ends inside, at and past a 64-row tile
    and a 2,048-row dW chunk: rows past C stay in the expert's own
    workspace segment, and its chunks' partial sums reduce in order."""
    _check_case(kernels, 2, c, m, 3, torch.float32, cuda, seed=c + m,
                skips=(1,))


@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("m", [256, 512])
def test_fp32_bwd_kernels_single_expert_and_edge_skips(cuda, m, kernels):
    """One expert over two dW chunks, and skips at the first and the last
    layer (the last layer's skip input and no mask)."""
    _check_case(kernels, 1, _CHUNK_ROWS + 300, m, 4, torch.float32, cuda,
                seed=m + 51, skips=(2,))
    _check_case(kernels, 3, 200, m, 4, torch.float32, cuda, seed=m + 52,
                skips=(0, 3))


@pytest.mark.parametrize("kernels", KERNELS)
def test_fp32_bwd_kernels_take_32_layers_at_width_512(cuda, kernels):
    """The ReLU masks stay bits in shared memory up to K2R's depth (9
    layers at M = 512) and are read back from hsave past it: 9, 10 and 32
    layers match the plain versions, and the fp32 limit stays 32 (33
    raise)."""
    assert expert_kernel.bwd_max_layers(cuda, 512, torch.float32) == 32
    for layers, skips in ((9, (3,)), (10, (3, 9)), (32, (3, 17, 31))):
        _check_case(kernels, 2, 130, 512, layers, torch.float32, cuda,
                    seed=61 + layers, skips=skips)
    x, ws, bs, gy = _chain_case(2, 130, 512, 1, torch.float32, cuda, seed=62)
    w33, b33 = _chain_weights(2, 512, 33, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError):
        if kernels == "chain":
            expert_kernel.expert_mlp_chain_bwd(x, w33, b33, gy)
        else:
            tokens_ext, stt = _fused_case(x, 63)
            fused_dispatch.fused_dispatch_chain_bwd(tokens_ext, stt, w33, b33,
                                                    gy)


@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("m", [256, 512])
def test_fp32_bwd_kernels_are_deterministic(cuda, m, kernels):
    """dx, dW and db bit-identical over two launches (fixed-order sums and
    chunk reduction, no atomics), over outputs allocated on NaN bytes."""
    x, ws, bs, gy = _chain_case(4, 3000, m, 7, torch.float32, cuda,
                                seed=m + 71)
    if kernels == "chain":
        def run():
            return expert_kernel.expert_mlp_chain_bwd(x, ws, bs, gy, (3,))
    else:
        tokens_ext, stt = _fused_case(x, m + 72)

        def run():
            return fused_dispatch.fused_dispatch_chain_bwd(
                tokens_ext, stt, ws, bs, gy, (3,))
    _dirty_allocator(cuda)
    first = run()
    _dirty_allocator(cuda)
    second = run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("m", [256, 512])
def test_fp32_bwd_kernels_error_against_float64(cuda, m, kernels):
    """At Building's and Mission Bay's fp32 layer shape (L7 skip 3, E4
    C3000) the 3xTF32 K2/K4's largest error against a float64 run of the
    plain chain (autograd) is at most 4x the plain fp32 backward's, as for
    K2R."""
    skips = (3,)
    x, ws, bs, gy = _chain_case(4, 3000, m, 7, torch.float32, cuda,
                                seed=m + 81)
    if kernels == "chain":
        xd = x
        kernel = expert_kernel.expert_mlp_chain_bwd(x, ws, bs, gy, skips)
        plain = expert_kernel.expert_mlp_chain_bwd_plain(x, ws, bs, gy,
                                                         skips)
    else:
        tokens_ext, stt = _fused_case(x, m + 82)
        xd = tokens_ext[stt.long()].view(x.shape)       # the dispatched rows
        kernel = fused_dispatch.fused_dispatch_chain_bwd(tokens_ext, stt, ws,
                                                         bs, gy, skips)
        plain = fused_dispatch.fused_dispatch_chain_bwd_plain(
            tokens_ext, stt, ws, bs, gy, skips)
    wide = [t.double().requires_grad_() for t in (xd, ws, bs)]
    ref = expert_kernel.expert_mlp_chain_plain(*wide, skips)
    ref = torch.autograd.grad(ref, wide, gy.double())

    def errs(out):
        return [((o.double() - w).abs().max() / w.abs().max()).item()
                for o, w in zip(out, ref)]
    for name, k, p in zip(("dx", "dW", "db"), errs(kernel), errs(plain)):
        assert k <= 4 * p, (name, k, p)


# ------------------------------------------------- fp32 K1/K3, 3xTF32 ----
# fp32 K1 and K3 run K1R's forward (csrc/chain_tf32.cuh chain_fwd_tf32,
# kInPlace / kGather): 64-row tiles, a partial last tile zero-filled on load
# and clipped on store; at M = 512 four passes of 128 columns a layer, the
# skip input held in out (K3: the gathered tile written there first).

def _fwd_pair(kernels, x, ws, bs, skips, seed):
    """(kernel launch, plain version) of K1 ("chain") or K3 ("fused", the
    E*C rows as tokens over a slot map with empty slots) on x [E, C, M]."""
    if kernels == "chain":
        return (lambda: expert_kernel.expert_mlp_chain_fwd(x, ws, bs, skips),
                lambda: expert_kernel.expert_mlp_chain_plain(x, ws, bs,
                                                             skips))
    tokens_ext, stt = _fused_case(x, seed)
    return (lambda: fused_dispatch.fused_dispatch_chain_fwd(
                tokens_ext, stt, ws, bs, skips),
            lambda: fused_dispatch.fused_dispatch_chain_plain(
                tokens_ext, stt, ws, bs, skips))


def _check_fp32_fwd(kernels, e, c, m, layers, skips, device, seed):
    """fp32 K1 / K3 launched once (over NaN-filled memory) against its
    plain version."""
    x, ws, bs, _ = _chain_case(e, c, m, layers, torch.float32, device, seed)
    run, plain = _fwd_pair(kernels, x, ws, bs, skips, seed + 2)
    mod = expert_kernel if kernels == "chain" else fused_dispatch
    before = mod.launches
    _dirty_allocator(device)
    out = run()
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    _assert_close(out, plain(), torch.float32)


@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("m", [64, 128, 256, 512])
@pytest.mark.parametrize("c", [1, 63, 64, 65, 200])
def test_fp32_fwd_kernels_across_the_tile_edge(cuda, c, m, kernels):
    """fp32 K1 and K3 where C ends inside, at and past a 64-row tile."""
    _check_fp32_fwd(kernels, 2, c, m, 7, (3,), cuda, seed=c + m + 101)


@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("m", [64, 128, 256, 512])
def test_fp32_fwd_kernels_single_expert_and_edge_skips(cuda, m, kernels):
    """One expert over several tiles, and skips at the first and the last
    layer (the last layer's skip input, no ReLU after it)."""
    _check_fp32_fwd(kernels, 1, 300, m, 4, (2,), cuda, seed=m + 111)
    _check_fp32_fwd(kernels, 3, 200, m, 4, (0, 3), cuda, seed=m + 112)


@pytest.mark.parametrize("skips", [(), (0,), (2, 5), (1, 4, 6)])
def test_fp32_gathered_fwd_skip_input_at_width_512(cuda, skips):
    """K3 at M = 512 holds the skip input in out, where it writes the
    gathered tile before layer 0: skip layers after layer 0, over a slot
    map that permutes the tokens (every slot's row is another token's, so
    a skip input read from the token array at the slot's own row would
    show), with empty slots and C off the tile edge."""
    e, c, m = 3, 150, 512
    x, ws, bs, _ = _chain_case(e, c, m, 7, torch.float32, cuda, seed=121)
    tokens_ext = torch.cat([x.reshape(-1, m), x.new_zeros((1, m))])
    g = torch.Generator().manual_seed(122)
    perm = torch.randperm(e * c, generator=g)
    stt = torch.empty_like(perm)
    stt[perm] = perm.roll(1)                # one cycle: no slot keeps its row
    stt[torch.rand(e * c, generator=g) < 0.2] = e * c
    stt = stt.to(cuda, torch.int32)
    assert not bool((stt == torch.arange(e * c, device=cuda)).any())
    before = fused_dispatch.launches
    out = fused_dispatch.fused_dispatch_chain_fwd(tokens_ext, stt, ws, bs,
                                                  skips)
    torch.cuda.synchronize()
    assert fused_dispatch.launches == before + 1
    _assert_close(out, fused_dispatch.fused_dispatch_chain_plain(
        tokens_ext, stt, ws, bs, skips), torch.float32)


@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("m", [256, 512])
def test_fp32_fwd_kernels_are_deterministic(cuda, m, kernels):
    """Two launches on the same inputs give the same bits (over NaN-filled
    memory), and the 3xTF32 forward is what ran."""
    from torch.profiler import ProfilerActivity, profile
    x, ws, bs, _ = _chain_case(4, 3000, m, 7, torch.float32, cuda,
                               seed=m + 131)
    run, _ = _fwd_pair(kernels, x, ws, bs, (3,), m + 132)
    _dirty_allocator(cuda)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        first = run()
        torch.cuda.synchronize()
    _dirty_allocator(cuda)
    second = run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert bool(torch.isfinite(first).all())
    names = [ev.key for ev in prof.key_averages()]
    assert any("chain_fwd_tf32" in n for n in names), names


@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("m", [256, 512])
def test_fp32_fwd_kernels_error_against_float64(cuda, m, kernels):
    """At Building's and Mission Bay's fp32 layer shape (L7 skip 3, E4
    C3000) the 3xTF32 K1/K3's largest error against a float64 run of the
    plain chain is at most 4x the plain fp32 chain's, as for K1R."""
    x, ws, bs, _ = _chain_case(4, 3000, m, 7, torch.float32, cuda,
                               seed=m + 141)
    run, plain = _fwd_pair(kernels, x, ws, bs, (3,), m + 142)
    if kernels == "chain":
        xd = x
    else:
        tokens_ext, stt = _fused_case(x, m + 142)
        xd = tokens_ext[stt.long()].view(x.shape)       # the dispatched rows
    ref = expert_kernel.expert_mlp_chain_plain(xd.double(), ws.double(),
                                               bs.double(), (3,))

    def err(out):
        return ((out.double() - ref).abs().max() / ref.abs().max()).item()
    k, p = err(run()), err(plain())
    assert k <= 4 * p, (k, p)
