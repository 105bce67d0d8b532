"""PyTorch port vs the JAX package: encoding, routing, dispatch, sorting and
volume rendering, on the CPU, with numpy inputs made from a seed.

Tolerances: fp32 values 1e-6 (absolute, or relative where the value is
large) unless a test states otherwise; integer routing plans bit-equal.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from switch_nerf_tpu.ops import encoding as jenc
from switch_nerf_tpu.ops import routing as jrouting
from switch_nerf_tpu.ops import sorting as jsorting
from switch_nerf_tpu.ops import volume as jvolume
from switch_nerf_torch.ops import dispatch as tdispatch
from switch_nerf_torch.ops import encoding as tenc
from switch_nerf_torch.ops import routing as trouting
from switch_nerf_torch.ops import sorting as tsorting
from switch_nerf_torch.ops import volume as tvolume

# the JAX ops package re-exports a function named `dispatch`, which hides
# the submodule from `from ... import`
jdispatch = importlib.import_module("switch_nerf_tpu.ops.dispatch")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("num_freqs", [0, 1, 4, 12])
def test_freq_encode_fp32(num_freqs):
    x = np.random.default_rng(num_freqs).uniform(-2, 2, (64, 3)) \
        .astype(np.float32)
    ref = jenc.freq_encode(jnp.asarray(x), num_freqs)
    out = tenc.freq_encode(torch.from_numpy(x), num_freqs)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-6, rtol=0)


def test_freq_encode_bf16_builds_angles_in_bf16():
    """Under AMP the angles and the pi/2 phase are bf16; tolerance is one
    bf16 ulp at |v| < 1 (2^-8), for sin implementations that round apart."""
    x = np.random.default_rng(5).uniform(-1, 1, (256, 3)).astype(np.float32)
    ref = jenc.freq_encode(jnp.asarray(x, jnp.bfloat16), 4)
    out = tenc.freq_encode(torch.from_numpy(x).bfloat16(), 4)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), atol=2 ** -8, rtol=0)


def test_shifted_softplus():
    x = np.concatenate([np.linspace(-30, 30, 301),
                        [20.5, 21.0, 22.0]]).astype(np.float32)
    np.testing.assert_allclose(
        _np(tenc.shifted_softplus(torch.from_numpy(x))),
        _np(jenc.shifted_softplus(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def _gates(s, e, seed, skew=0.0, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(s, e)).astype(np.float32)
    logits[:, 0] += skew                       # overflow expert 0
    if ties:
        logits[::4, 1] = logits[::4, 0]        # argmax ties between 0 and 1
        logits[1::7] = logits[0]               # duplicated rows: BPR ties
    g = np.exp(logits - logits.max(1, keepdims=True))
    return (g / g.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("bpr", [False, True])
@pytest.mark.parametrize("cf,skew,ties", [
    (1.0, 0.0, True), (1.0, 2.0, False), (0.5, 0.0, True), (2.0, 1.0, True),
    (0.0, 1.0, False)])
def test_extract_critical_plans_bit_equal(bpr, cf, skew, ties):
    g = _gates(96, 4, seed=int(10 * cf + skew), skew=skew, ties=ties)
    jplan, jl = jrouting.extract_critical(jnp.asarray(g), 1, cf, bpr)
    tplan, tl = trouting.extract_critical(torch.from_numpy(g), 1, cf, bpr)
    assert tplan.capacity == jplan.capacity
    for name in ("indices", "locations", "expert_counts"):
        np.testing.assert_array_equal(
            getattr(tplan, name).numpy(), np.asarray(getattr(jplan, name)),
            err_msg=name)
    np.testing.assert_allclose(tplan.gates.numpy(), np.asarray(jplan.gates),
                               atol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    if skew >= 2.0:                            # the case must really drop
        assert (tplan.locations >= tplan.capacity).any()


@pytest.mark.parametrize("postscore,no_score", [
    (True, False), (False, False), (True, True)])
def test_dispatch_combine_match_jax(postscore, no_score):
    s, e, m = 80, 4, 16
    g = _gates(s, e, seed=3, skew=1.5, ties=True)
    x = np.random.default_rng(4).normal(size=(s, m)).astype(np.float32)
    y = np.random.default_rng(5).normal(
        size=(e, s // e, m)).astype(np.float32)
    jplan, _ = jrouting.extract_critical(jnp.asarray(g), 1, 1.0, True)
    tplan, _ = trouting.extract_critical(torch.from_numpy(g), 1, 1.0, True)
    jdp = jdispatch.build_dispatch_plan(jplan, e)
    tdp = tdispatch.build_dispatch_plan(tplan, e)
    for name in ("slot", "kept", "slot_to_token", "filled"):
        np.testing.assert_array_equal(getattr(tdp, name).numpy(),
                                      np.asarray(getattr(jdp, name)),
                                      err_msg=name)
    kw = dict(is_postscore=postscore, no_score=no_score)
    td = tdispatch.dispatch(torch.from_numpy(x), tdp, **kw)
    np.testing.assert_allclose(
        td.numpy(), _np(jdispatch.dispatch(jnp.asarray(x), jdp, **kw)),
        atol=1e-6)
    np.testing.assert_allclose(
        td.numpy(), tdispatch.dispatch_einsum_oracle(
            torch.from_numpy(x), tdp, **kw).numpy(), atol=1e-6)
    tc = tdispatch.combine(torch.from_numpy(y), tdp, **kw)
    np.testing.assert_allclose(
        tc.numpy(), _np(jdispatch.combine(jnp.asarray(y), jdp, **kw)),
        atol=1e-6)
    np.testing.assert_allclose(
        tc.numpy(), tdispatch.combine_einsum_oracle(
            torch.from_numpy(y), tdp, **kw).numpy(), atol=1e-6)


def test_sort_with_payloads_matches_jax():
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 20, (8, 50)).astype(np.float32)   # many ties
    pay = rng.normal(size=(8, 50)).astype(np.float32)
    jk, jp = jsorting.sort_with_payloads(jnp.asarray(keys), jnp.asarray(pay))
    tk, tp = tsorting.sort_with_payloads(torch.from_numpy(keys),
                                         torch.from_numpy(pay))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("flip", [False, True])
def test_volume_render_matches_jax(flip):
    rng = np.random.default_rng(7)
    n, s = 32, 24
    rgbs = rng.uniform(size=(n, s, 3)).astype(np.float32)
    sig = rng.uniform(0, 5, (n, s)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 3, (n, s)), -1).astype(np.float32)
    if flip:
        z = z[:, ::-1].copy()
    ld = np.where(rng.uniform(size=(n, 1)) < 0.5, 1e10, 0.3) \
        .astype(np.float32)
    dr = rng.uniform(1, 9, (n, s)).astype(np.float32)
    for kw in ({"get_depth": True},
               {"depth_real": dr, "get_depth": True, "white_bkgd": True}):
        jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()}
        jr = jvolume.volume_render(jnp.asarray(rgbs), jnp.asarray(sig),
                                   jnp.asarray(z), jnp.asarray(ld),
                                   flip=flip, **jkw)
        tr = tvolume.volume_render(torch.from_numpy(rgbs),
                                   torch.from_numpy(sig), torch.from_numpy(z),
                                   torch.from_numpy(ld), flip=flip, **tkw)
        # rtol 1e-5: the transmittance cumprod multiplies in another order
        for name in tr._fields:
            a, b = getattr(tr, name), getattr(jr, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5,
                                           atol=1e-6, err_msg=name)


def test_sample_pdf_matches_sort_based_lookup():
    """searchsorted + gathers vs the JAX package's sort-based interval
    lookup, including flat CDF stretches (zero weights). Tolerance 1e-5:
    the two cumsums add in another order, and a sample divides by its
    bin's CDF step."""
    rng = np.random.default_rng(8)
    n, b = 16, 31
    bins = np.sort(rng.uniform(0.5, 3, (n, b + 1)), -1).astype(np.float32)
    w = rng.uniform(size=(n, b)).astype(np.float32)
    w[:, 5:12] = 0.0
    w[3] = 0.0
    ref = jvolume.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 40, True, None)
    out = tvolume.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 40)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=1e-5)


def test_sphere_geometry_matches_jax():
    rng = np.random.default_rng(9)
    n, s = 40, 12
    o = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = np.array([0.05, -0.02, 0.1], np.float32)
    r = np.array([1.2, 0.9, 1.0], np.float32)
    depth = np.broadcast_to(np.linspace(0, 1, s, dtype=np.float32), (n, s))
    jf = jvolume.intersect_sphere(*map(jnp.asarray, (o, d, c, r)))
    tf = tvolume.intersect_sphere(*map(torch.from_numpy, (o, d, c, r)))
    np.testing.assert_allclose(tf.numpy(), _np(jf), rtol=1e-6, atol=1e-6)
    jp, jd = jvolume.depth2pts_outside(
        jnp.asarray(o[:, None]), jnp.asarray(d[:, None]), jnp.asarray(depth),
        jnp.asarray(c), jnp.asarray(r))
    tp, td = tvolume.depth2pts_outside(
        torch.from_numpy(o[:, None]), torch.from_numpy(d[:, None]),
        torch.from_numpy(depth.copy()), torch.from_numpy(c),
        torch.from_numpy(r))
    np.testing.assert_allclose(tp.numpy(), _np(jp), rtol=1e-5, atol=1e-6)
    # depth_real reaches ~1e8 at zero inverse depth: compare relatively
    np.testing.assert_allclose(td.numpy(), _np(jd), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- training --

def _dispatch_case(s=80, e=4, m=16, seed=3):
    g = _gates(s, e, seed=seed, skew=1.5)
    jplan, _ = jrouting.extract_critical(jnp.asarray(g), 1, 1.0, True)
    tplan, _ = trouting.extract_critical(torch.from_numpy(g), 1, 1.0, True)
    return (jdispatch.build_dispatch_plan(jplan, e),
            tdispatch.build_dispatch_plan(tplan, e))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("postscore,no_score", [
    (True, False), (False, False), (True, True)])
def test_dispatch_combine_grads_match_jax_vjps(postscore, no_score, dtype):
    """d(tokens), d(expert output) and d(gates) against the JAX custom VJPs
    (gathers over the inverse slot map, fp32 row dots for the gate). fp32
    to 1e-6; bf16 to one bf16 ulp of the largest entry (2^-8 relative):
    both sides round the same products, but in their own order."""
    s, e, m = 80, 4, 16
    jdp, tdp = _dispatch_case(s, e, m)
    assert not bool(tdp.kept.all())            # the case drops tokens
    rng = np.random.default_rng(11)
    x = rng.normal(size=(s, m)).astype(np.float32)
    y = rng.normal(size=(e, s // e, m)).astype(np.float32)
    gd = rng.normal(size=(e, s // e, m)).astype(np.float32)
    gc = rng.normal(size=(s, m)).astype(np.float32)
    kw = dict(is_postscore=postscore, no_score=no_score)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jfn(xx, yy, gates):
        dp = jdp._replace(gates=gates)
        return (jdispatch.dispatch(xx, dp, **kw),
                jdispatch.combine(yy, dp, **kw))

    _, vjp = jax.vjp(jfn, jnp.asarray(x, jdt), jnp.asarray(y, jdt),
                     jdp.gates)
    jd_x, jd_y, jd_g = vjp((jnp.asarray(gd, jdt), jnp.asarray(gc)))

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ty = torch.from_numpy(y).to(tdt).requires_grad_()
    tg = tdp.gates.clone().requires_grad_()
    dp = tdp._replace(gates=tg)
    outs = (tdispatch.dispatch(tx, dp, **kw), tdispatch.combine(ty, dp, **kw))
    d_x, d_y, d_g = torch.autograd.grad(
        outs, (tx, ty, tg), (torch.from_numpy(gd).to(tdt),
                             torch.from_numpy(gc)), allow_unused=True)
    if d_g is None:                   # no_score: the gates are not used
        d_g = torch.zeros_like(tg)
    assert d_x.dtype == d_y.dtype == tdt and d_g.dtype == torch.float32
    for name, a, b in (("d tokens", d_x, jd_x), ("d expert out", d_y, jd_y),
                       ("d gates", d_g, jd_g)):
        b = _np(b)
        tol = 1e-6 if dtype == "float32" else 2 ** -8 * np.abs(b).max()
        np.testing.assert_allclose(_np(a), b, atol=tol, rtol=0, err_msg=name)


def test_extract_critical_grads_match_jax():
    """l_aux and the top-1 gate scores pass gradient to the softmax gates
    (load_balance through `me`, the gates through the top-1 pick); the
    integer plan carries none. Gates without ties: JAX's max splits a tied
    gradient, torch's gather does not."""
    g = _gates(96, 4, seed=21, skew=1.0)
    w = np.random.default_rng(22).normal(size=(1, 96)).astype(np.float32)

    def jloss(gates):
        plan, l_aux = jrouting.extract_critical(gates, 1, 1.0, True)
        return 5.0 * l_aux + jnp.sum(plan.gates * w)

    ref = jax.grad(jloss)(jnp.asarray(g))
    tg = torch.from_numpy(g).requires_grad_()
    plan, l_aux = trouting.extract_critical(tg, 1, 1.0, True)
    assert not any(t.requires_grad for t in (plan.indices, plan.locations))
    (5.0 * l_aux + torch.sum(plan.gates * torch.from_numpy(w))).backward()
    np.testing.assert_allclose(tg.grad.numpy(), _np(ref), atol=1e-6)


def test_expand_and_perturb_z_vals_with_jax_draw():
    """Stratified jitter fed JAX's own draw jax.random.uniform(key, shape):
    the same numbers to 1e-6; no jitter without a generator or a draw."""

    z = np.broadcast_to(np.linspace(0.5, 2.5, 33, dtype=np.float32),
                        (20, 33)).copy()
    key = jax.random.PRNGKey(3)
    ref = jvolume.expand_and_perturb_z_vals(jnp.asarray(z), 0.7, key)
    u = np.array(jax.random.uniform(key, z.shape, dtype=jnp.float32))
    out = tvolume.expand_and_perturb_z_vals(torch.from_numpy(z), 0.7,
                                            u=torch.from_numpy(u))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6, rtol=0)
    assert tvolume.expand_and_perturb_z_vals(torch.from_numpy(z), 0.7) \
        .equal(torch.from_numpy(z))
    gen = torch.Generator().manual_seed(0)
    a = tvolume.expand_and_perturb_z_vals(torch.from_numpy(z), 1.0, gen)
    assert bool(((a[:, 1:] - a[:, :-1]) >= 0).all())      # stays sorted


def test_sample_pdf_random_with_jax_draw():
    """Random inverse-CDF samples fed JAX's own draw, to 1e-6 (1e-5 where a
    sample divides by a small CDF step, as the deterministic test)."""

    rng = np.random.default_rng(23)
    n, b, f = 16, 31, 40
    bins = np.sort(rng.uniform(0.5, 3, (n, b + 1)), -1).astype(np.float32)
    w = rng.uniform(size=(n, b)).astype(np.float32)
    w[:, 4:9] = 0.0
    key = jax.random.PRNGKey(5)
    ref = jvolume.sample_pdf(jnp.asarray(bins), jnp.asarray(w), f, False, key)
    u = np.array(jax.random.uniform(key, (n, f), dtype=jnp.float32))
    out = tvolume.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), f,
                             det=False, u=torch.from_numpy(u))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("flip", [False, True])
def test_volume_render_depth_variance_and_grads_match_jax(flip):
    """Depth variance, the random background colour, and the gradient of a
    loss on rgb + depth + depth variance w.r.t. rgbs and sigmas: depth and
    its variance pass none (stop_gradient / detach). rtol 1e-5 as above."""

    rng = np.random.default_rng(24)
    n, s = 24, 16
    rgbs = rng.uniform(size=(n, s, 3)).astype(np.float32)
    sig = rng.uniform(0, 3, (n, s)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 3, (n, s)), -1).astype(np.float32)
    if flip:
        z = z[:, ::-1].copy()
    ld = np.full((n, 1), 1e10, np.float32)
    bgc = np.array([0.2, 0.5, 0.9], np.float32)
    wr = rng.normal(size=(n, 3)).astype(np.float32)

    def jloss(r, sg):
        vr = jvolume.volume_render(r, sg, jnp.asarray(z), jnp.asarray(ld),
                                   flip=flip, get_depth=True,
                                   get_depth_variance=True,
                                   background_color=jnp.asarray(bgc))
        return (jnp.sum(vr.rgb * wr) + jnp.sum(vr.depth)
                + jnp.sum(vr.depth_variance)), vr

    (_, jvr), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                          has_aux=True)(
        jnp.asarray(rgbs), jnp.asarray(sig))
    tr = torch.from_numpy(rgbs).requires_grad_()
    ts = torch.from_numpy(sig).requires_grad_()
    tvr = tvolume.volume_render(tr, ts, torch.from_numpy(z),
                                torch.from_numpy(ld), flip=flip,
                                get_depth=True, get_depth_variance=True,
                                background_color=torch.from_numpy(bgc))
    assert not tvr.depth.requires_grad and not tvr.depth_variance.requires_grad
    (torch.sum(tvr.rgb * torch.from_numpy(wr)) + torch.sum(tvr.depth)
     + torch.sum(tvr.depth_variance)).backward()
    for name in ("rgb", "depth", "depth_variance"):
        np.testing.assert_allclose(_np(getattr(tvr, name)),
                                   _np(getattr(jvr, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tr.grad.numpy(), _np(jgrads[0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), _np(jgrads[1]), rtol=1e-5,
                               atol=1e-6)
