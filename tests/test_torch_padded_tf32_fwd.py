"""The arithmetic of the fp32 K1/K3 kernels (csrc/chain_tf32.cuh's
forward with the padded row sources kInPlace / kGather), emulated on the CPU
against the JAX package's Pallas forwards.

The card's forward, step by step as it takes it: each layer's product
h W_l in split precision (``test_torch_tf32.py``'s ``split``), over k in
stages of 16, each stage a fresh sum of the small products hi*lo' + lo*hi'
and then hi*hi', added to the running sum by an fp32 add; then + b_l, the
skip input and the ReLU in the plain chain's order. The gathered form runs
the same chain on the token rows the slot map names (empty slots: the zero
row).

Held against ``expert_kernel._fwd_call(..., interpret=True)`` and, over a
slot map with dropped tokens and empty slots, ``fused_dispatch._fwd_call``,
at Mission Bay's layer (M = 512, L7, skip 3, E = 2) and Building's width
(M = 256), C off the 64-row tile edge: within 1e-4 of the largest entry,
and within 4x of the plain fp32 chain's error against a float64 run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu.ops import expert_kernel as jek
from switch_nerf_tpu.ops import fused_dispatch as jfd
from switch_nerf_torch.ops.expert_kernel import expert_mlp_chain_plain
from tests.test_torch_padded_tf32 import E, LAYERS, SKIPS, _slot_map, _weights
from tests.test_torch_tf32 import split

FP32_REL_TOL = 1e-4   # the fp32 forwards' limit, relative to max |ref|
STAGE_K = 16          # k a stage of the weight ring (chain_tf32.cuh)


def mm_staged_3xtf32(a, b):
    """a [E, R, K] @ b [E, K, N] as the card's forward sums it."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = None
    for k0 in range(0, a.shape[-1], STAGE_K):
        k = slice(k0, k0 + STAGE_K)
        part = ah[..., k] @ bl[..., k, :] + al[..., k] @ bh[..., k, :]
        part = part + ah[..., k] @ bh[..., k, :]
        acc = part if acc is None else acc + part
    return acc


def padded_fwd(x, ws, bs):
    """fp32 K1's output as the card computes it, x [E, C, M]."""
    h = xin = x
    for l in range(LAYERS):
        z = mm_staged_3xtf32(h, ws[l]) + bs[l]
        last = l == LAYERS - 1
        if l in SKIPS:
            z = z + xin
            if not last:
                z = torch.relu(z)
            xin = z
        elif not last:
            z = torch.relu(z)
        h = z
    return h


def _check(got, jax_ref, x, ws, bs):
    """got within 1e-4 of max |JAX's _fwd_call|, and within 4x of the plain
    fp32 chain's error against float64."""
    ref = np.asarray(jax_ref, np.float32)
    err = np.abs(got.numpy() - ref).max()
    assert err <= FP32_REL_TOL * np.abs(ref).max(), err
    wide = expert_mlp_chain_plain(x.double(), ws.double(), bs.double(), SKIPS)

    def rel(out):
        return ((out.double() - wide).abs().max() / wide.abs().max()).item()
    plain = rel(expert_mlp_chain_plain(x, ws, bs, SKIPS))
    assert rel(got) <= 4 * plain, (rel(got), plain)


@pytest.mark.parametrize("m,c", [pytest.param(512, 100, id="m512"),
                                 pytest.param(256, 160, id="m256")])
def test_padded_3xtf32_fwd_matches_pallas(m, c):
    """K1's emulated forward vs the Pallas _fwd_call (interpret)."""
    ws, bs, rng = _weights(m, seed=m + 3)
    x = rng.normal(0, 1, (E, c, m)).astype(np.float32)
    jax_ref = jek._fwd_call(*map(jnp.asarray, (x, ws, bs)), SKIPS,
                            interpret=True)
    args = [torch.from_numpy(a) for a in (x, ws, bs)]
    _check(padded_fwd(*args), jax_ref, *args)


@pytest.mark.parametrize("m,s,cap", [pytest.param(512, 150, 96, id="m512"),
                                     pytest.param(256, 120, 72, id="m256")])
def test_gathered_3xtf32_fwd_matches_pallas(m, s, cap):
    """K3's: the rows gathered through a slot map with dropped tokens and
    empty slots (the zero row), vs the Pallas fused _fwd_call."""
    ws, bs, rng = _weights(m, seed=m + 11)
    tokens = rng.normal(0, 1, (s, m)).astype(np.float32)
    stt = _slot_map(rng, s, cap)
    jtok = np.concatenate([tokens, np.zeros((1 + (-(s + 1)) % 8, m),
                                            np.float32)])
    jax_ref = jfd._fwd_call(jnp.asarray(jtok), jnp.asarray(stt),
                            *map(jnp.asarray, (ws, bs)), SKIPS)
    tokens_ext = np.concatenate([tokens, np.zeros((1, m), np.float32)])
    xd = torch.from_numpy(tokens_ext[stt.astype(np.int64)].reshape(E, cap, m))
    args = [xd] + [torch.from_numpy(a) for a in (ws, bs)]
    _check(padded_fwd(*args), jax_ref, *args)
