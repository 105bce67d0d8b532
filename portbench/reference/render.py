"""Plain float32 volume rendering of the benchmark's configurations: the
Mega-NeRF renderer (coarse and fine samples, a foreground NeRF inside the
scene's ellipsoid and an inverted-sphere background NeRF outside it).

The random draws of a training pass (stratified jitter, the sigma noise of
each model call, the fine samples' uniforms) come from one
``torch.Generator`` in a fixed order, the order the renderer under test
documents: the background pass first (its jitter, each coarse call's
noise, the fine uniforms, each fine call's noise), then the foreground
pass alike. Given the same generator state, both draw the same numbers.

Model calls go through ``Chunks``: the points of a pass are cut into
calls of ``chunk`` points (the last one shorter), as the routing of an MoE
layer is decided per call. In training a ``Chunks`` keeps each call's
inputs and returns its outputs as leaves, so that the loss's gradient
reaches them; ``backward`` then runs every call again with gradients and
sends it its outputs' gradient. Only one call's activations live at a
time.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

class Chunks:
    """Model calls over `chunk`-point pieces. fn(points, sigma_noise) ->
    (outputs [n, 4], moe_loss [L])."""

    def __init__(self, fn: Callable, chunk: int, generator=None,
                 noise_std: float = 0.0, train: bool = False):
        self.fn, self.chunk = fn, chunk
        self.generator, self.noise_std = generator, noise_std
        self.train = train
        self.calls: List[tuple] = []

    def __call__(self, pts: torch.Tensor):
        n = pts.shape[0]
        step = min(self.chunk, n)
        outs, losses = [], []
        for lo in range(0, n, step):
            piece = pts[lo:lo + step]
            noise = None
            if self.train and self.noise_std > 0:
                noise = self.noise_std * torch.randn(
                    (piece.shape[0], 1), generator=self.generator,
                    dtype=torch.float32, device=pts.device)
            with torch.no_grad():
                out, loss = self.fn(piece, noise)
            if self.train:
                out = out.detach().requires_grad_()
                loss = loss.detach().requires_grad_()
                self.calls.append((piece, noise, out, loss))
            outs.append(out)
            losses.append(loss)
        return torch.cat(outs), torch.stack(losses)

    def backward(self) -> None:
        """Each kept call again with gradients, its outputs' gradients sent
        back into the parameters."""
        for piece, noise, out, loss in self.calls:
            if out.grad is None and loss.grad is None:
                continue
            o, l = self.fn(piece, noise)
            pairs = [(t, g) for t, g in ((o, out.grad), (l, loss.grad))
                     if g is not None and t.requires_grad]
            torch.autograd.backward([t for t, _ in pairs],
                                    [g for _, g in pairs])
        self.calls.clear()


# ---------------------------------------------------------- geometry ---

def volume_render(rgbs, sigmas, z, last_delta, flip=False, depth_real=None):
    """Alpha compositing of [N, S] samples: (rgb [N, 3], depth [N],
    weights [N, S], the light left after the last sample [N])."""
    d = z[..., :-1] - z[..., 1:] if flip else z[..., 1:] - z[..., :-1]
    d = torch.cat([d, last_delta], dim=-1)
    alphas = 1.0 - torch.exp(-d * sigmas)
    t = torch.cumprod(1.0 - alphas + 1e-8, dim=-1)
    shifted = torch.cat([torch.ones_like(t[..., :1]), t[..., :-1]], dim=-1)
    w = alphas * shifted
    rgb = torch.sum(w[..., None] * rgbs, dim=-2)
    dr = (z if depth_real is None else depth_real).detach()
    depth = torch.sum(w.detach() * dr, dim=-1)
    return rgb, depth, w, t[..., -1]


def jitter(z, generator):
    """Stratified jitter: each depth uniform in the interval its
    neighbours' midpoints bound."""
    mids = 0.5 * (z[..., :-1] + z[..., 1:])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    u = torch.rand(z.shape, generator=generator, dtype=z.dtype,
                   device=z.device)
    return lower + (upper - lower) * u


def sample_pdf(bins, weights, n, generator):
    """Inverse-CDF samples [N, n] of the piecewise-constant density
    weights [N, B] over bins [N, B + 1]; uniform queries in training,
    evenly spaced ones without a generator."""
    weights = weights + 1e-8
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]),
                     torch.cumsum(pdf, dim=-1)], dim=-1)
    rays = cdf.shape[0]
    if generator is None:
        u = torch.linspace(0.0, 1.0, n, device=cdf.device).expand(rays, n)
    else:
        u = torch.rand((rays, n), generator=generator, dtype=cdf.dtype,
                       device=cdf.device)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(c1 - c0 < 1e-8, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def exit_depth(o, d, center, radius):
    """Depth at which each ray leaves the ellipsoid (center, radius)."""
    o = (o - center) / radius
    d = d / radius
    d1 = -torch.sum(d * o, dim=-1) / torch.sum(d * d, dim=-1)
    p = o + d1[..., None] * d
    p2 = torch.clamp(torch.sum(p * p, dim=-1), 0.0, 1.0 - 1e-6)
    return d1 + torch.sqrt(1.0 - p2) / torch.linalg.norm(d, dim=-1)


def outside_points(o, d, depth, center, radius):
    """NeRF++'s inverted-sphere points for inverse depths `depth` [N, S]
    along rays o, d [N, 1, 3]: (points [N, S, 4], real depth [N, S])."""
    o = (o - center) / radius
    d = d / radius
    d1 = -torch.sum(d * o, dim=-1) / torch.sum(d * d, dim=-1)
    p_mid = o + d1[..., None] * d
    p_mid_norm = torch.linalg.norm(p_mid, dim=-1)
    cos_d = 1.0 / torch.linalg.norm(d, dim=-1)
    d2 = torch.sqrt(torch.clamp(1.0 - p_mid_norm ** 2, min=0.0)) * cos_d
    p_sphere = o + (d1 + d2)[..., None] * d
    axis = torch.linalg.cross(o, p_sphere, dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-8)
    phi = torch.arcsin(torch.clamp(p_mid_norm, -1.0, 1.0))
    theta = torch.arcsin(torch.clamp(p_mid_norm * depth, -1.0, 1.0))
    angle = (phi - theta)[..., None]
    cos_a, sin_a = torch.cos(angle), torch.sin(angle)
    shape = angle.shape[:-1] + (3,)
    rotated = (p_sphere * cos_a
               + torch.linalg.cross(axis.expand(shape), p_sphere.expand(shape),
                                    dim=-1) * sin_a
               + axis * torch.sum(axis * p_sphere, dim=-1, keepdim=True)
               * (1.0 - cos_a))
    rotated = rotated / torch.linalg.norm(rotated, dim=-1, keepdim=True)
    real = 1.0 / (depth + 1e-8) * torch.cos(theta) + d1
    return torch.cat([rotated, depth[..., None]], dim=-1), real


def _points(xyz, d, idx):
    """[N, S, k] samples with the ray's direction and appearance index ->
    [N * S, k + 4] model inputs."""
    n, s, k = xyz.shape
    return torch.cat([xyz.reshape(n * s, k),
                      d.expand(n, s, 3).reshape(n * s, 3),
                      idx.float()[:, None, None].expand(n, s, 1)
                      .reshape(n * s, 1)], dim=-1)


def _query(model: Chunks, xyz, d, idx):
    n, s, _ = xyz.shape
    out, loss = model(_points(xyz, d, idx))
    out = out.reshape(n, s, 4)
    return out[..., :3], out[..., 3], loss.reshape(-1)


def _merge(z, rgb, sigma, real=None):
    """Sort samples by z, carrying their colour, density (and depth)."""
    z, perm = torch.sort(z, dim=-1, stable=True)
    rgb = torch.stack([rgb[..., c].gather(-1, perm) for c in range(3)], -1)
    sigma = sigma.gather(-1, perm)
    return z, rgb, sigma, (None if real is None else real.gather(-1, perm))


# ---------------------------------------------------------- Mega-NeRF ---

def render_mega(fg: Chunks, bg: Chunks, rays, idx, center, radius,
                coarse: int, fine: int, generator=None) -> Dict:
    """rays [N, 8] (o, d, near, far). With a generator: training draws.
    Returns rgb_fine, depth_fine, gate_loss_coarse, gate_loss_fine."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    fg_far = torch.maximum(exit_depth(o, d, center, radius), near[:, 0])
    bg_mask = far[:, 0] > fg_far
    last_delta = torch.where(bg_mask, fg_far,
                             torch.full_like(fg_far, 1e10))[:, None]
    far = torch.minimum(far[:, 0], fg_far)[:, None]
    o3, d3 = o[:, None], d[:, None]

    # background: inverse depths ascending, the model sees them far first
    n = rays.shape[0]
    sb = coarse // 2
    bz = torch.linspace(0.0, 1.0, sb, device=rays.device).expand(n, sb)
    if generator is not None:
        bz = jitter(bz, generator)
    pts, real = outside_points(o3, d3, bz, center, radius)
    rgb_c, sig_c, _ = _query(bg, torch.flip(pts, (-2,)), d3, idx)
    zc, realc = torch.flip(bz, (-1,)), torch.flip(real, (-1,))
    inf = torch.full((n, 1), 1e10, device=rays.device)
    _, _, w, _ = volume_render(rgb_c, sig_c, zc, inf, flip=True,
                               depth_real=realc)
    mids = torch.flip(0.5 * (zc[:, :-1] + zc[:, 1:]), (-1,))
    bzf = torch.sort(sample_pdf(mids, w[:, 1:-1].detach(), fine // 2,
                                generator), dim=-1).values
    pts_f, real_f = outside_points(o3, d3, bzf, center, radius)
    rgb_f, sig_f, _ = _query(bg, torch.flip(pts_f, (-2,)), d3, idx)
    zf, realf = torch.flip(bzf, (-1,)), torch.flip(real_f, (-1,))
    z, rgb, sig, rl = _merge(-torch.cat([zf, zc], -1),
                             torch.cat([rgb_f, rgb_c], -2),
                             torch.cat([sig_f, sig_c], -1),
                             torch.cat([realf, realc], -1))
    bg_rgb, bg_depth, _, _ = volume_render(rgb, sig, -z, inf, flip=True,
                                           depth_real=rl)

    # foreground
    steps = torch.linspace(0.0, 1.0, coarse, device=rays.device)
    z = near * (1 - steps) + far * steps
    if generator is not None:
        z = jitter(z, generator)
    rgb_c, sig_c, loss_c = _query(fg, o3 + d3 * z[..., None], d3, idx)

    def adjust(ld, zz):
        finite = ld[:, 0] < 1e10
        return ld - torch.where(finite, zz.max(dim=-1).values,
                                torch.zeros_like(ld[:, 0]))[:, None]
    _, _, w, _ = volume_render(rgb_c, sig_c, z, adjust(last_delta, z))
    mids = 0.5 * (z[:, :-1] + z[:, 1:])
    fz = sample_pdf(mids, w[:, 1:-1].detach(), fine, generator)
    rgb_f, sig_f, loss_f = _query(fg, o3 + d3 * fz[..., None], d3, idx)
    za, rgba, siga, _ = _merge(torch.cat([fz, z], -1),
                               torch.cat([rgb_f, rgb_c], -2),
                               torch.cat([sig_f, sig_c], -1))
    rgb, depth, _, bg_lambda = volume_render(rgba, siga, za,
                                             adjust(last_delta, fz))
    m = bg_mask.float()
    return {"rgb_fine": rgb + bg_rgb * bg_lambda[:, None] * m[:, None],
            "depth_fine": depth + bg_depth * bg_lambda * m,
            "gate_loss_coarse": loss_c, "gate_loss_fine": loss_f}
