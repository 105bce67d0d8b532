"""The port's kernel modules vs the JAX package's Pallas kernels, on the CPU,
forward and backward.

The JAX kernels run in interpret mode, as the JAX package's own tests run
them; the port's wrappers take their plain PyTorch versions for CPU
tensors. (The CUDA kernels themselves are held against those plain versions
on the card: tests/test_torch_cuda.py and chip_smoke.py.)

Tolerances: fp32 1e-5 (matmuls sum in another order; dW relative to
max |dW|, which sums C products); bf16 2e-2 * max |ref| (bf16 rounding at
every layer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu.models.moe import MoELayer as JMoELayer
from switch_nerf_tpu.ops import expert_kernel as jek
from switch_nerf_tpu.ops import fused_dispatch as jfd
from switch_nerf_tpu.ops.expert_kernel import expert_mlp_chain as jchain
from switch_nerf_tpu.ops.fused_dispatch import fused_dispatch_chain as jfused
from switch_nerf_torch import bridge
from switch_nerf_torch.models import experts as texperts
from switch_nerf_torch.models.moe import MoELayer as TMoELayer
from switch_nerf_torch.ops import expert_kernel, fused_dispatch


def _chain_inputs(e, c, m, layers, seed):
    """x ~ N(0, 1); W and b ~ N(0, 0.1) at M = 128, N(0, 0.1 sqrt(128 / M))
    wider, so every width keeps activations of the same order."""
    rng = np.random.default_rng(seed)
    scale = 0.1 * min(1.0, (128 / m) ** 0.5)
    return (rng.normal(0, 1, (e, c, m)).astype(np.float32),
            rng.normal(0, scale, (layers, e, m, m)).astype(np.float32),
            rng.normal(0, scale, (layers, e, 1, m)).astype(np.float32))


# the shapes of tests/test_expert_kernel.py (M = 128), and Mission Bay's
# width, which the fp32 kernels take since the M = 512 slice
CHAIN_CASES = [pytest.param(1, (), 128, id="1-skips0"),
               pytest.param(3, (1,), 128, id="3-skips1"),
               pytest.param(4, (1, 3), 128, id="4-skips2"),
               pytest.param(3, (2,), 128, id="3-skips3"),
               pytest.param(3, (1,), 512, id="3-skips1-m512")]


@pytest.mark.parametrize("layers,skips,m", CHAIN_CASES)
def test_chain_plain_matches_pallas_fp32(layers, skips, m):
    x, ws, bs = _chain_inputs(2, 64, m, layers, seed=layers * 10 + len(skips))
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
        *map(torch.from_numpy, (tokens, stt, ws, bs, dummy_slot)),
        torch.zeros(s_ext, dtype=torch.bool), skips)
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
    tokens = torch.zeros(5, 64, device="meta")
    stt = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fused_dispatch.fused_dispatch_chain(
            tokens, stt, ws, bs, torch.zeros(5, dtype=torch.long),
            torch.zeros(5, dtype=torch.bool))
    with pytest.raises(ValueError):
        expert_kernel.expert_mlp_chain_bwd(
            torch.zeros(1, 4, 64, device="meta"), ws, bs,
            torch.zeros(1, 4, 64, device="meta"))
    with pytest.raises(ValueError):
        fused_dispatch.fused_dispatch_chain_bwd(
            tokens, stt, ws, bs, torch.zeros(1, 4, 64, device="meta"))


def _close(out, ref, tol, rel=False, err_msg=""):
    """max |out - ref| <= tol (times max |ref| when rel)."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max() if rel else 1.0
    err = np.abs(out - ref).max()
    assert err <= tol * scale, (err_msg, err, tol * scale)


@pytest.mark.parametrize("layers,skips,m", CHAIN_CASES)
def test_chain_bwd_plain_matches_pallas_fp32(layers, skips, m):
    """expert_mlp_chain_bwd_plain vs the Pallas _bwd_call (interpret), and
    the port's autograd (ExpertChainFn) vs jax.vjp of the custom-VJP chain:
    dx and db to 1e-5, dW to 1e-5 of max |dW|."""
    x, ws, bs = _chain_inputs(2, 64, m, layers, seed=layers * 10 + 1)
    g = np.random.default_rng(layers).normal(size=x.shape).astype(np.float32)
    jdx, jdw, jdb = jek._bwd_call(*map(jnp.asarray, (x, ws, bs, g)), skips,
                                  interpret=True)
    tx, tws, tbs, tg = map(torch.from_numpy, (x, ws, bs, g))
    dx, dw, db = expert_kernel.expert_mlp_chain_bwd_plain(tx, tws, tbs, tg,
                                                          skips)
    assert dw.dtype == db.dtype == torch.float32
    _close(dx, jdx, 1e-5, err_msg="dx")
    _close(dw, jdw, 1e-5, rel=True, err_msg="dW")
    _close(db, jdb, 1e-5, rel=True, err_msg="db")

    _, vjp = jax.vjp(lambda a, b, c: jchain(a, b, c, skips, True),
                     *map(jnp.asarray, (x, ws, bs)))
    refs = vjp(jnp.asarray(g))
    leaves = [t.clone().requires_grad_() for t in (tx, tws, tbs)]
    out = expert_kernel.expert_mlp_chain(*leaves, skips)
    grads = torch.autograd.grad(out, leaves, tg)
    for name, a, b in zip(("dx", "dW", "db"), grads, refs):
        _close(a, b, 1e-5, rel=name != "dx", err_msg=name)


def test_chain_bwd_plain_matches_pallas_bf16():
    x, ws, bs = _chain_inputs(2, 64, 128, 3, seed=8)
    g = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    jdx, jdw, jdb = jek._bwd_call(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, ws, bs, g)), (1,),
        interpret=True)
    dx, dw, db = expert_kernel.expert_mlp_chain_bwd_plain(
        *(torch.from_numpy(a).bfloat16() for a in (x, ws, bs, g)), (1,))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    for name, a, b in (("dx", dx, jdx), ("dW", dw, jdw), ("db", db, jdb)):
        _close(a.float(), np.asarray(b, np.float32), 2e-2, rel=True,
               err_msg=name)


def _main_path_chain(dtype, seed=21):
    """The main path's chain structure (M=256, L=7, skip at 3) at a ragged
    C=40, weights at the init scale M^-0.5 so seven layers keep values of
    order one. Returns the numpy inputs and the port's tensors in dtype."""
    e, c, m, layers = 2, 40, 256, 7
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(0, 1, (e, c, m)).astype(np.float32),
              rng.normal(0, m ** -0.5, (layers, e, m, m)).astype(np.float32),
              rng.normal(0, m ** -0.5, (layers, e, 1, m)).astype(np.float32),
              rng.normal(0, 1, (e, c, m)).astype(np.float32))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.from_numpy(a).to(dtype) for a in arrays])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_plain_matches_pallas_at_main_path_structure(dtype):
    """The oracle the card kernels are held to, at M=256, L=7, skips (3,):
    the plain chain and plain backward vs the Pallas _fwd_call/_bwd_call
    (interpret). fp32 to 1e-5 of max |ref|, bf16 to 2e-2 of max |ref|."""
    skips = (3,)
    (jx, jws, jbs, jg), (tx, tws, tbs, tg) = _main_path_chain(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    ref = jek._fwd_call(jx, jws, jbs, skips, interpret=True)
    out = expert_kernel.expert_mlp_chain_plain(tx, tws, tbs, skips)
    assert out.dtype == dtype
    _close(out.float(), np.asarray(ref, np.float32), tol, rel=True,
           err_msg="y")
    refs = jek._bwd_call(jx, jws, jbs, jg, skips, interpret=True)
    outs = expert_kernel.expert_mlp_chain_bwd_plain(tx, tws, tbs, tg, skips)
    for name, a, b in zip(("dx", "dW", "db"), outs, refs):
        _close(a.float(), np.asarray(b, np.float32), tol, rel=True,
               err_msg=name)


def _fused_case(e=4, cap=32, s=100, m=128, layers=3, seed=5):
    """A top-1 slot map with empty slots and dropped tokens, as
    build_dispatch_plan makes it: the port's single zero row, and JAX's
    rows padded to a multiple of 8."""
    rng = np.random.default_rng(seed)
    _, ws, bs = _chain_inputs(e, 1, m, layers, seed=seed + 1)
    tokens = rng.normal(size=(s, m)).astype(np.float32)
    expert = rng.integers(0, e, s)
    expert[: s // 3] = 0                      # overflow expert 0: drops
    slot = np.full(s, e * cap, np.int64)
    stt = np.full(e * cap, s, np.int32)       # empty -> the zero row
    fill = np.zeros(e, np.int64)
    for t in range(s):
        if fill[expert[t]] < cap:
            slot[t] = expert[t] * cap + fill[expert[t]]
            stt[slot[t]] = t
            fill[expert[t]] += 1
    kept = slot < e * cap
    assert (~kept).any() and (stt == s).any()
    return tokens, stt, ws, bs, slot, kept


@pytest.mark.parametrize("dtype,m", [
    pytest.param(torch.float32, 256, id="dtype0"),
    pytest.param(torch.bfloat16, 256, id="dtype1"),
    pytest.param(torch.float32, 512, id="dtype0-m512")])
def test_fused_plain_matches_pallas_at_main_path_structure(dtype, m):
    """The oracle K3/K4 are held to on the card, at M=256 (and fp32 at
    Mission Bay's 512), L=7, skips (3,): the plain fused forward and
    backward vs the Pallas _fwd_call/_bwd_call (interpret) on a slot map
    with dropped tokens and empty slots, weights at the init scale M^-0.5.
    JAX's tokens are padded to a multiple of 8 rows. fp32 to 1e-5 of
    max |ref|, bf16 to 2e-2 of max |ref|."""
    skips = (3,)
    tokens, stt, _, _, _, _ = _fused_case(m=m, layers=7, seed=23)
    s, m = tokens.shape
    e, layers = 4, 7
    cap = stt.size // e
    rng = np.random.default_rng(24)
    ws = rng.normal(0, m ** -0.5, (layers, e, m, m)).astype(np.float32)
    bs = rng.normal(0, m ** -0.5, (layers, e, 1, m)).astype(np.float32)
    g = rng.normal(0, 1, (e, cap, m)).astype(np.float32)
    jtok = np.concatenate([tokens, np.zeros((1 + (-(s + 1)) % 8, m),
                                            np.float32)])
    ttok = np.concatenate([tokens, np.zeros((1, m), np.float32)])
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = [jnp.asarray(a, jdtype) for a in (jtok, ws, bs, g)]
    tx = [torch.from_numpy(a).to(dtype) for a in (ttok, ws, bs, g)]
    tol = 1e-5 if dtype == torch.float32 else 2e-2

    ref = jfd._fwd_call(jx[0], jnp.asarray(stt), jx[1], jx[2], skips)
    out = fused_dispatch.fused_dispatch_chain_plain(
        tx[0], torch.from_numpy(stt), tx[1], tx[2], skips)
    assert out.dtype == dtype
    _close(out.float(), np.asarray(ref, np.float32), tol, rel=True,
           err_msg="y")
    refs = jfd._bwd_call(jx[0], jnp.asarray(stt), jx[1], jx[2], jx[3], skips)
    outs = fused_dispatch.fused_dispatch_chain_bwd_plain(
        tx[0], torch.from_numpy(stt), tx[1], tx[2], tx[3], skips)
    for name, a, b in zip(("d(dispatched)", "dW", "db"), outs, refs):
        _close(a.float(), np.asarray(b, np.float32), tol, rel=True,
               err_msg=name)


def test_fused_bwd_matches_jax_vjp():
    """FusedDispatchFn's d(tokens), dW, db vs jax.vjp of the JAX
    fused_dispatch_chain (Pallas K3/K4 in interpret mode) at M=128 with
    empty slots and dropped tokens; the plain backward's d(dispatched) vs
    the Pallas _bwd_call. Tolerances as the chain's fp32 ones."""
    tokens, stt, ws, bs, slot, kept = _fused_case()
    s, m = tokens.shape
    e, cap = ws.shape[1], stt.size // ws.shape[1]
    pad = (-(s + 1)) % 8
    jtok = np.concatenate([tokens, np.zeros((1 + pad, m), np.float32)])
    jslot = np.concatenate([slot, np.full(1 + pad, e * cap)]).astype(np.int32)
    jkept = np.concatenate([kept, np.zeros(1 + pad, bool)])
    g = np.random.default_rng(6).normal(size=(e, cap, m)).astype(np.float32)

    _, vjp = jax.vjp(
        lambda t, w, b: jfused(t, jnp.asarray(stt), w, b, jnp.asarray(jslot),
                               jnp.asarray(jkept), (1,)),
        *map(jnp.asarray, (jtok, ws, bs)))
    jd_tok, jdw, jdb = vjp(jnp.asarray(g))
    jdxd, _, _ = jfd._bwd_call(jnp.asarray(jtok), jnp.asarray(stt),
                               jnp.asarray(ws), jnp.asarray(bs),
                               jnp.asarray(g), (1,))

    ttok = torch.from_numpy(np.concatenate([tokens, np.zeros((1, m),
                                                             np.float32)]))
    tstt = torch.from_numpy(stt)
    tws, tbs = torch.from_numpy(ws), torch.from_numpy(bs)
    dxd, _, _ = fused_dispatch.fused_dispatch_chain_bwd_plain(
        ttok, tstt, tws, tbs, torch.from_numpy(g), (1,))
    _close(dxd, jdxd, 1e-5, err_msg="d(dispatched)")

    leaves = [t.clone().requires_grad_() for t in (ttok, tws, tbs)]
    out = fused_dispatch.fused_dispatch_chain(
        leaves[0], tstt, leaves[1], leaves[2],
        torch.from_numpy(np.concatenate([slot, [e * cap]])),
        torch.from_numpy(np.concatenate([kept, [False]])), (1,))
    d_tok, dw, db = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _close(d_tok, np.asarray(jd_tok)[: s + 1], 1e-5, err_msg="d(tokens)")
    assert not d_tok[torch.from_numpy(~np.concatenate([kept, [False]]))].any()
    _close(dw, jdw, 1e-5, rel=True, err_msg="dW")
    _close(db, jdb, 1e-5, rel=True, err_msg="db")


@pytest.mark.parametrize("fused", ["0", "1"])
def test_moe_layer_grads_match_jax(monkeypatch, fused):
    """Train-mode MoELayer gradients (x, gate input, every parameter) vs
    JAX's, through dispatch/combine's custom VJPs and the chain's (K2/K4's
    plain versions here, Pallas in interpret mode on the JAX side when
    fused). Tolerance 1e-5, relative to the largest entry per leaf."""
    monkeypatch.setenv("SWITCH_NERF_FUSED_DISPATCH", fused)
    x, gi = _moe_data()
    w_out = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    jlayer = JMoELayer(model_dim=128, num_experts=4, layer_num=3, skips=(1,),
                       top_k=1, capacity_factor=1.0,
                       batch_prioritized_routing=True,
                       train_dispatch="padded", eval_dispatch="padded")
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(gi))

    def jloss(p, xx, gg):
        y, l_aux, _ = jlayer.apply(p, xx, gg, deterministic=False)
        return jnp.sum(y * w_out) + 3.0 * l_aux

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(x), jnp.asarray(gi))

    tlayer = TMoELayer(model_dim=128, num_experts=4, layer_num=3, skips=(1,),
                       capacity_factor=1.0, batch_prioritized_routing=True)
    bridge.load_jax_params(
        tlayer, jax.tree_util.tree_map(np.asarray, params["params"]))
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(gi).requires_grad_()
    y, l_aux, _ = tlayer(tx, tg, train=True)
    (torch.sum(y * torch.from_numpy(w_out)) + 3.0 * l_aux).backward()
    _close(tx.grad, jgrads[1], 1e-5, rel=True, err_msg="dx")
    _close(tg.grad, jgrads[2], 1e-5, rel=True, err_msg="d gate input")
    tparams = dict(tlayer.named_parameters())
    for path, ref in jax.tree_util.tree_leaves_with_path(jgrads[0]["params"]):
        name = ".".join(k.key for k in path)
        if name == "wg.kernel":               # [in, out] vs torch's [out, in]
            grad = tparams["wg.weight"].grad.T
        else:
            grad = tparams[name].grad
        _close(grad, ref, 1e-5, rel=True, err_msg=name)
