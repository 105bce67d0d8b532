"""The arithmetic of the fp32 K2/K4 kernels (csrc/chain_tf32.cuh with the
padded row sources kInPlace / kGather), emulated on the CPU against the JAX
package's Pallas backwards.

The card's design, step by step as the kernels take it:

- the recompute runs in exact fp32 (on the card one FMA chain over k from
  zero, the plain chain's order), so its ReLU masks are the plain chain's;
- the reverse sweep's products gh = G_l W_l^T and the dW products
  H_l^T G_l run in split precision, 3xTF32 (``test_torch_tf32.py``'s
  ``split``: hi*hi' + hi*lo' + lo*hi');
- dW and db are summed per chunk of an expert's rows (2,048 on the card;
  smaller here, so a small C crosses chunk edges), then over the chunks in
  ascending order (``rows.cuh`` ``reduce_partials``); db sums G's hi + lo.

Held against ``expert_kernel._bwd_call(..., interpret=True)`` and, for the
gathered form over a slot map with dropped tokens and empty slots,
``fused_dispatch._bwd_call``, at Mission Bay's layer (M = 512, L7, skip 3,
E = 2) and Building's width (M = 256): within the fp32 kernels' limit
(1e-4; dW and db relative to their largest entry) and within 4x of the
plain fp32 chain's error against a float64 run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu.ops import expert_kernel as jek
from switch_nerf_tpu.ops import fused_dispatch as jfd
from switch_nerf_torch.ops.expert_kernel import (expert_mlp_chain_bwd_plain,
                                                 expert_mlp_chain_plain)
from tests.test_torch_tf32 import split

LAYERS, SKIPS, E = 7, (3,), 2
FP32_TOL = 1e-4     # the fp32 kernels' limit against their plain versions


def mm_3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return ah @ bh + ah @ bl + al @ bh


def padded_bwd(x, ws, bs, g, chunk):
    """fp32 K2's (dx, dW, db) as the card computes them, x [E, C, M]."""
    layers = ws.shape[0]
    hs, h, xin = [], x, x                        # exact fp32 recompute
    for l in range(layers):
        hs.append(h)
        z = torch.matmul(h, ws[l]) + bs[l]
        last = l == layers - 1
        if l in SKIPS:
            z = z + xin
            if not last:
                z = torch.relu(z)
            xin = z
        elif not last:
            z = torch.relu(z)
        h = z
    gh, gxin = g, torch.zeros_like(g)
    dws, dbs = [None] * layers, [None] * layers
    rows = x.shape[1]
    for l in range(layers - 1, -1, -1):
        gl = gh
        if l in SKIPS:
            gl = gl + gxin
        if l < layers - 1:
            gl = gl * (hs[l + 1] > 0).to(gl.dtype)
        if l in SKIPS:
            gxin = gl
        ghi, glo = split(gl)                     # gsave's hi and lo
        dw = db = None
        for r0 in range(0, rows, chunk):         # chunks, then in order
            part = torch.stack([
                mm_3xtf32(hs[l][e, r0:r0 + chunk].T.contiguous(),
                          gl[e, r0:r0 + chunk]) for e in range(E)])
            dpart = (ghi + glo)[:, r0:r0 + chunk].sum(1, keepdim=True)
            dw = part if dw is None else dw + part
            db = dpart if db is None else db + dpart
        dws[l], dbs[l] = dw, db
        gh = torch.stack([mm_3xtf32(gl[e], ws[l, e].T.contiguous())
                          for e in range(E)])
    return gh + gxin, torch.stack(dws), torch.stack(dbs)


def _weights(m, seed):
    rng = np.random.default_rng(seed)
    bound = m ** -0.5
    return (rng.uniform(-bound, bound, (LAYERS, E, m, m)).astype(np.float32),
            rng.uniform(-bound, bound, (LAYERS, E, 1, m)).astype(np.float32),
            rng)


def _slot_map(rng, s, cap):
    """A top-1 slot map over s tokens: expert 0 overflows (dropped tokens),
    expert 1 leaves empty slots (-> the zero row s)."""
    expert = np.where(np.arange(s) < 2 * s // 3, 0, 1)
    stt = np.full(E * cap, s, np.int32)
    fill = np.zeros(E, np.int64)
    for t in rng.permutation(s):
        e = expert[t]
        if fill[e] < cap:
            stt[e * cap + fill[e]] = t
            fill[e] += 1
    assert fill[0] == cap and fill[1] < cap and (stt == s).any()
    return stt


def _rel_errs(outs, refs):
    return [((o.double() - r).abs().max() / r.abs().max()).item()
            for o, r in zip(outs, refs)]


def _check(got, jax_ref, plain, wide_args):
    """got within 1e-4 of JAX's _bwd_call, and within 4x of the plain fp32
    backward's error against float64 (autograd of the plain chain)."""
    for name, a, b, rel in zip(("dx", "dW", "db"), got, jax_ref,
                               (False, True, True)):
        b = np.asarray(b, np.float32)
        scale = np.abs(b).max() if rel else 1.0
        err = np.abs(a.numpy() - b).max()
        assert err <= FP32_TOL * scale, (name, err, FP32_TOL * scale)
    wide = [t.double().requires_grad_() for t in wide_args[:3]]
    ref = expert_mlp_chain_plain(*wide, SKIPS)
    refs = torch.autograd.grad(ref, wide, wide_args[3].double())
    for name, k, p in zip(("dx", "dW", "db"), _rel_errs(got, refs),
                          _rel_errs(plain, refs)):
        assert k <= 4 * p, (name, k, p)


@pytest.mark.parametrize("m,c,chunk", [
    pytest.param(512, 100, 2048, id="m512-one-chunk"),
    pytest.param(512, 100, 48, id="m512-chunks-48"),
    pytest.param(256, 160, 64, id="m256-chunks-64")])
def test_padded_3xtf32_bwd_matches_pallas(m, c, chunk):
    """K2's emulated design vs the Pallas _bwd_call (interpret)."""
    ws, bs, rng = _weights(m, seed=m + chunk)
    x = rng.normal(0, 1, (E, c, m)).astype(np.float32)
    g = rng.normal(0, 1, (E, c, m)).astype(np.float32)
    jax_ref = jek._bwd_call(*map(jnp.asarray, (x, ws, bs, g)), SKIPS,
                            interpret=True)
    args = [torch.from_numpy(a) for a in (x, ws, bs, g)]
    got = padded_bwd(*args, chunk)
    _check(got, jax_ref, expert_mlp_chain_bwd_plain(*args, SKIPS), args)


@pytest.mark.parametrize("chunk", [2048, 40])
def test_gathered_3xtf32_bwd_matches_pallas(chunk):
    """K4's: the rows gathered through a slot map with dropped tokens and
    empty slots (the zero row), M = 512, vs the Pallas fused _bwd_call."""
    m, s, cap = 512, 150, 96
    ws, bs, rng = _weights(m, seed=chunk + 7)
    tokens = rng.normal(0, 1, (s, m)).astype(np.float32)
    stt = _slot_map(rng, s, cap)
    g = rng.normal(0, 1, (E, cap, m)).astype(np.float32)
    jtok = np.concatenate([tokens, np.zeros((1 + (-(s + 1)) % 8, m),
                                            np.float32)])
    jax_ref = jfd._bwd_call(jnp.asarray(jtok), jnp.asarray(stt),
                            *map(jnp.asarray, (ws, bs, g)), SKIPS)
    tokens_ext = np.concatenate([tokens, np.zeros((1, m), np.float32)])
    xd = torch.from_numpy(tokens_ext[stt.astype(np.int64)].reshape(E, cap, m))
    args = [xd] + [torch.from_numpy(a) for a in (ws, bs, g)]
    got = padded_bwd(*args, chunk)
    _check(got, jax_ref, expert_mlp_chain_bwd_plain(*args, SKIPS), args)
