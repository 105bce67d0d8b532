"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. This file imports no JAX, so on a machine with a card (and no JAX)
it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: fp32 max |kernel - plain| <= 1e-4 (fp32 sums in another order);
bf16 max |kernel - plain| <= 2e-2 * max |plain| (bf16 rounding at each
layer, where a 1-ulp flip moves later layers).
"""
import pytest
import torch

from switch_nerf_torch.ops import expert_kernel, fused_dispatch

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


def _assert_close(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        assert err <= 2e-2 * ref.float().abs().max().item(), err


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
    # a slot map with empty slots (-> the zero row s) and unused tokens
    stt = torch.randint(0, s, (e * cap,), generator=g)
    stt[torch.rand(e * cap, generator=g) < 0.3] = s
    stt = stt.to(cuda, torch.int32)
    before = fused_dispatch.launches
    out = fused_dispatch.fused_dispatch_chain(tokens_ext, stt, ws, bs, skips)
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
        fused_dispatch.fused_dispatch_chain(
            torch.randn(41, 128, device=cuda),
            torch.zeros(80, dtype=torch.int64, device=cuda), ws, bs)
