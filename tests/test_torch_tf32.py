"""The numerical premise of the fp32 K1R/K2R kernels (csrc/chain_tf32.cuh),
emulated on the CPU: split precision on TF32 tensor cores ("3xTF32").

The kernels round each fp32 operand a to hi = rna_tf32(a) and
lo = rna_tf32(a - hi) (``cvt.rna.tf32.f32``: round to nearest on the 13 low
mantissa bits, ties away from zero) and sum hi*hi' + hi*lo' + lo*hi' in fp32
(the tensor cores multiply tf32 values exactly and accumulate in fp32).
Here that arithmetic runs in torch, at the structure of Bungee's expert
layer (M = 256, L = 7, skip 3) and at Mission Bay's width (M = 512: K = 512
per product, the fp32 Mission Bay kernels' depth), forward and backward,
against the port's plain fp32 chain and a float64 run:

- the 3-product chain stays within the kernels' fp32 limit (1e-4) of the
  plain fp32 chain, and within 4x of the plain chain's own error against
  float64;
- a single TF32 product per step misses both.
"""
import numpy as np
import pytest
import torch

from switch_nerf_torch.ops.expert_kernel import (expert_mlp_chain_bwd_plain,
                                                 expert_mlp_chain_plain)

M, LAYERS, SKIPS, ROWS = 256, 7, (3,), 512
FP32_TOL = 1e-4     # the fp32 kernels' limit against the plain chain


def rna_tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 value (10 mantissa bits), ties away from
    zero: add half of the 13 dropped bits' unit to the magnitude bits, then
    clear them (the sign bit is apart from the magnitude)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(a: torch.Tensor):
    hi = rna_tf32(a)
    return hi, rna_tf32(a - hi)


def mm_3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return ah @ bh + ah @ bl + al @ bh


def mm_tf32(a, b):
    return rna_tf32(a) @ rna_tf32(b)


def _chain(x, ws, bs, mm):
    """The expert chain of one expert (x [N, M], ws [L, M, M], bs [L, 1, M])
    with every product taken by mm; returns the output and each layer's
    input (and the output last)."""
    h = xin = x
    hs = []
    for l in range(LAYERS):
        hs.append(h)
        z = mm(h, ws[l]) + bs[l]
        last = l == LAYERS - 1
        if l in SKIPS:
            z = z + xin
            if not last:
                z = torch.relu(z)
            xin = z
        elif not last:
            z = torch.relu(z)
        h = z
    return h, hs + [h]


def _chain_bwd(x, ws, bs, g, mm):
    """(dx, dW, db) of _chain at cotangent g, the kernels' sweep order."""
    _, hs = _chain(x, ws, bs, mm)
    gh, gxin = g, torch.zeros_like(g)
    dws, dbs = [None] * LAYERS, [None] * LAYERS
    for l in range(LAYERS - 1, -1, -1):
        gl = gh
        if l in SKIPS:
            gl = gl + gxin
        if l < LAYERS - 1:
            gl = gl * (hs[l + 1] > 0).to(gl.dtype)
        if l in SKIPS:
            gxin = gl
        dws[l] = mm(hs[l].T.contiguous(), gl)
        dbs[l] = gl.sum(0, keepdim=True)
        gh = mm(gl, ws[l].T.contiguous())
    return gh + gxin, torch.stack(dws), torch.stack(dbs)


def _make_case(m, seed):
    """Inputs and weights from a seed (the card tests' uniform init), the
    plain fp32 chain's outputs (the port's plain versions) and a float64
    run's, each as [out, dx, dW, db]."""
    rng = np.random.default_rng(seed)
    bound = m ** -0.5
    ws = torch.from_numpy(rng.uniform(-bound, bound, (LAYERS, m, m))
                          .astype(np.float32))
    bs = torch.from_numpy(rng.uniform(-bound, bound, (LAYERS, 1, m))
                          .astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (ROWS, m)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (ROWS, m)).astype(np.float32))
    plain = [expert_mlp_chain_plain(x[None], ws[:, None], bs[:, None],
                                    SKIPS)[0]]
    dx, dw, db = expert_mlp_chain_bwd_plain(x[None], ws[:, None],
                                            bs[:, None], g[None], SKIPS)
    plain += [dx[0], dw[:, 0], db[:, 0]]
    wide = [t.double() for t in (x, ws, bs, g)]
    ref = [_chain(*wide[:3], torch.matmul)[0]]
    ref += list(_chain_bwd(*wide, torch.matmul))
    return (x, ws, bs, g), plain, ref


@pytest.fixture(scope="module")
def case():
    return _make_case(M, seed=0)


@pytest.fixture(scope="module")
def case512():
    return _make_case(512, seed=5)


def _run(args, mm):
    x, ws, bs, g = args
    return [_chain(x, ws, bs, mm)[0]] + list(_chain_bwd(x, ws, bs, g, mm))


def _rel_err(out, ref):
    return [((o.double() - r).abs().max() / r.abs().max()).item()
            for o, r in zip(out, ref)]


def test_rna_tf32_rounds_to_nearest_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10                  # tf32's unit in the last place at 1
    a = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0e-3, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp],
                        dtype=torch.float32)
    got = rna_tf32(a)
    assert torch.equal(got[:4], want)
    assert not (got.view(torch.int32) & 0x1FFF).any()   # 13 low bits clear
    assert (got[4] - a[4]).abs() <= 2.0 ** -11 * a[4].abs()
    hi, lo = split(torch.randn(4096, generator=torch.Generator()
                               .manual_seed(1)))
    back = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    assert ((hi + lo - back).abs() <= 2.0 ** -22 * back.abs()).all()


def test_three_product_chain_keeps_fp32_accuracy(case):
    """3xTF32 forward and backward: within 1e-4 of the plain fp32 chain
    (dW and db relative to their largest entry, as the card's checks), and
    within 4x of the plain chain's error against float64."""
    _check_three_products(case)


def test_three_product_chain_keeps_fp32_accuracy_at_width_512(case512):
    """The same at M = 512 (twice the products summed in each output)."""
    _check_three_products(case512)


def test_single_tf32_product_misses_the_fp32_limit_at_width_512(case512):
    _check_single_product(case512)


def _check_three_products(case):
    args, plain, ref = case
    out = _run(args, mm_3xtf32)
    for name, o, p, rel in zip(("out", "dx", "dW", "db"), out, plain,
                               (False, False, True, True)):
        scale = p.abs().max().item() if rel else 1.0
        assert (o - p).abs().max().item() <= FP32_TOL * scale, name
    for name, e3, ep in zip(("out", "dx", "dW", "db"), _rel_err(out, ref),
                            _rel_err(plain, ref)):
        assert e3 <= 4 * ep, (name, e3, ep)


def test_single_tf32_product_misses_the_fp32_limit(case):
    """One TF32 product per step (~11 bits) is off by more than the fp32
    limit already in the forward, and far more than 4x the plain chain's
    error against float64."""
    _check_single_product(case)


def _check_single_product(case):
    args, plain, ref = case
    out = _run(args, mm_tf32)
    assert (out[0] - plain[0]).abs().max().item() > FP32_TOL
    for name, e1, ep in zip(("out", "dx", "dW", "db"), _rel_err(out, ref),
                            _rel_err(plain, ref)):
        assert e1 > 4 * ep, (name, e1, ep)
