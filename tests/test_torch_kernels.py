"""The port's kernel modules vs the JAX package's Pallas kernels, on the CPU.

The JAX kernels run in interpret mode, as the JAX package's own tests run
them; the port's wrappers take their plain PyTorch versions for CPU
tensors. (The CUDA kernels themselves are held against those plain versions
on the card: tests/test_torch_cuda.py and chip_smoke.py.)

Tolerances: fp32 1e-5 (matmuls sum in another order); bf16 2e-2 * max |ref|
(bf16 rounding at every layer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu.models.moe import MoELayer as JMoELayer
from switch_nerf_tpu.ops.expert_kernel import expert_mlp_chain as jchain
from switch_nerf_tpu.ops.fused_dispatch import fused_dispatch_chain as jfused
from switch_nerf_torch import bridge
from switch_nerf_torch.models import experts as texperts
from switch_nerf_torch.models.moe import MoELayer as TMoELayer
from switch_nerf_torch.ops import expert_kernel, fused_dispatch


def _chain_inputs(e, c, m, layers, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (e, c, m)).astype(np.float32),
            rng.normal(0, 0.1, (layers, e, m, m)).astype(np.float32),
            rng.normal(0, 0.1, (layers, e, 1, m)).astype(np.float32))


# the shapes of tests/test_expert_kernel.py
@pytest.mark.parametrize("layers,skips", [
    (1, ()), (3, (1,)), (4, (1, 3)), (3, (2,))])
def test_chain_plain_matches_pallas_fp32(layers, skips):
    x, ws, bs = _chain_inputs(2, 64, 128, layers, seed=layers * 10 + len(skips))
    ref = jchain(jnp.asarray(x), jnp.asarray(ws), jnp.asarray(bs),
                 skips=skips, interpret=True)
    out = expert_kernel.expert_mlp_chain(*map(torch.from_numpy, (x, ws, bs)),
                                         skips)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_chain_plain_matches_pallas_bf16():
    x, ws, bs = _chain_inputs(2, 64, 128, 3, seed=7)
    ref = jchain(*(jnp.asarray(a, jnp.bfloat16) for a in (x, ws, bs)),
                 skips=(1,), interpret=True)
    out = expert_kernel.expert_mlp_chain(
        *(torch.from_numpy(a).bfloat16() for a in (x, ws, bs)), (1,))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 2e-2 * np.abs(ref).max(), err


def test_fused_plain_matches_pallas_with_empty_slots():
    e, cap, s, m, layers, skips = 4, 32, 100, 128, 3, (1,)
    _, ws, bs = _chain_inputs(e, 1, m, layers, seed=3)
    rng = np.random.default_rng(4)
    s_ext = s + 1 + (-(s + 1)) % 8            # JAX reads 8-row groups
    tokens = np.zeros((s_ext, m), np.float32)
    tokens[:s] = rng.normal(size=(s, m))
    stt = rng.integers(0, s, e * cap).astype(np.int32)
    stt[rng.uniform(size=e * cap) < 0.3] = s  # empty slots -> the zero row
    dummy_slot = np.full((s_ext,), e * cap, np.int32)
    ref = jfused(jnp.asarray(tokens), jnp.asarray(stt), jnp.asarray(ws),
                 jnp.asarray(bs), jnp.asarray(dummy_slot),
                 jnp.zeros((s_ext,), bool), skips)
    out = fused_dispatch.fused_dispatch_chain(
        *map(torch.from_numpy, (tokens, stt, ws, bs)), skips)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_fused_gating_conditions():
    """The port keeps the kernel's own shape limits, not the TPU's VMEM and
    8-row capacity conditions."""
    assert fused_dispatch.fused_supported((16384, 256), 8, 2048, 7)
    assert fused_dispatch.fused_supported((16384, 256), 8, 2049, 7)
    assert fused_dispatch.fused_supported((10 ** 7, 256), 8, 2048, 7)
    assert not fused_dispatch.fused_supported((16384, 192), 8, 2048, 7)
    assert not fused_dispatch.fused_supported((16384, 256), 8, 2048, 33)


def _moe_data(s=64, m=128, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (s, m)).astype(np.float32)
    gi = rng.normal(0, 1, (s, m)).astype(np.float32)
    gi[: s // 2] += 1.5               # unbalanced routing: capacity drops
    return x, gi


@pytest.mark.parametrize("fused", ["0", "1"])
def test_moe_layer_matches_jax(monkeypatch, fused):
    """MoELayer at model_dim 128 with SWITCH_NERF_FUSED_DISPATCH set the
    same on both sides (the pattern of tests/test_fused_dispatch.py)."""
    monkeypatch.setenv("SWITCH_NERF_FUSED_DISPATCH", fused)
    x, gi = _moe_data()
    jlayer = JMoELayer(model_dim=128, num_experts=4, layer_num=3, skips=(1,),
                       top_k=1, capacity_factor=1.0,
                       batch_prioritized_routing=True,
                       train_dispatch="padded", eval_dispatch="padded",
                       return_gates=True)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(gi))
    jy, jl, jextras = jlayer.apply(params, jnp.asarray(x), jnp.asarray(gi))

    tlayer = TMoELayer(model_dim=128, num_experts=4, layer_num=3, skips=(1,),
                       capacity_factor=1.0, batch_prioritized_routing=True,
                       return_gates=True)
    bridge.load_jax_params(
        tlayer, jax.tree_util.tree_map(np.asarray, params["params"]))
    calls = []
    real = texperts.fused_dispatch_chain
    monkeypatch.setattr(texperts, "fused_dispatch_chain",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        ty, tl, textras = tlayer(torch.from_numpy(x), torch.from_numpy(gi))
    assert len(calls) == (1 if fused == "1" else 0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_array_equal(textras["gates"].numpy(),
                                  np.asarray(jextras["gates"]))


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    """A tensor on neither CPU nor CUDA is refused, never computed."""
    ws = torch.zeros(1, 1, 64, 64, device="meta")
    bs = torch.zeros(1, 1, 1, 64, device="meta")
    with pytest.raises(ValueError):
        expert_kernel.expert_mlp_chain(torch.zeros(1, 4, 64, device="meta"),
                                       ws, bs)
    with pytest.raises(ValueError):
        fused_dispatch.fused_dispatch_chain(
            torch.zeros(5, 64, device="meta"),
            torch.zeros(4, dtype=torch.int32, device="meta"), ws, bs)
