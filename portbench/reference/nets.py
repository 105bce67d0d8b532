"""Plain float32 models of the benchmark's configurations, as functions of
a parameter dict.

The parameter names and shapes are this file's own (``param_spec``); the
harness draws the weights from the seed in that spec and loads the same
tensors into the program under test by name. Everything here is plain
PyTorch: no kernel, no routing or dispatch code of the program, no
import of it.

``Prec`` sets the precision of what the configuration computes in bf16
(the products of the trunk, the experts, the colour branch and the
background NeRF, their outputs and the colours): ``fp32`` is the
reference, ``fp8`` the control (each operand and each output scaled per
tensor into float8 e4m3 and back, the step below bf16). The gate and the
sigma heads stay float32, as the configuration states them; the
positional encodings and the models' outputs are in the configuration's
compute type (``encoder_dtype``, ``as_output``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


class Prec:
    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"precision {mode!r}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a product in the configured precision: float32 as
        it is, or rounded through float8 e4m3 at a per-tensor scale (the
        gradient passes straight through the rounding)."""
        if self.mode == "fp32":
            return t
        amax = t.detach().abs().amax().clamp(min=1e-30)
        scale = amax / FP8_MAX
        r = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return t + (r - t.detach())

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return self.q(y if b is None else y + b)


FP32 = Prec("fp32")


# --------------------------------------------------------------- spec ---

def _linear(spec, name, fan_in, fan_out, bias=True):
    spec[f"{name}.weight"] = ((fan_out, fan_in), fan_in)
    if bias:
        spec[f"{name}.bias"] = ((fan_out,), fan_in)


def moe_spec(cfg: dict, appearance_count: int) -> Dict[str, tuple]:
    """{name: (shape, fan_in)} of the NeRF-MoE graph the configuration
    names (fan_in 0: a LayerNorm scale, -1: its shift, None: the
    appearance table). ``cfg["model"]`` holds the widths."""
    m = cfg["model"]
    w, e, layers = m["width"], m["experts"], m["expert_layers"]
    pe = 3 * (1 + 2 * m["pos_xyz_dim"])
    spec: Dict[str, tuple] = {}
    _linear(spec, "layer_xyz.fc0", pe, w)
    _linear(spec, "layer_moe_external_gate.fc0", w, w)
    _linear(spec, "layer_moe_external_gate.fc1", w, w)
    spec["layer_gate_input_norm.weight"] = ((w,), 0)
    spec["layer_gate_input_norm.bias"] = ((w,), -1)
    spec["layer_0.wg.weight"] = ((e, w), w)
    for i in range(layers):
        spec[f"layer_0.experts.w{i}"] = ((e, w, w), w)
        spec[f"layer_0.experts.b{i}"] = ((e, 1, w), w)
    _linear(spec, "layer_sigma.fc0", w, 1)
    _linear(spec, "layer_1.fc0", w, w)
    dir_in = w + 3 * (1 + 2 * m["pos_dir_dim"]) + m["appearance_dim"]
    spec["embedding_a.weight"] = ((appearance_count, m["appearance_dim"]),
                                  None)
    _linear(spec, "layer_2.fc0", dir_in, m["color_width"])
    _linear(spec, "layer_color.fc0", m["color_width"], 3)
    return spec


def bg_spec(cfg: dict, appearance_count: int) -> Dict[str, tuple]:
    """The dense background NeRF's {name: (shape, fan_in)}."""
    b = cfg["bg_model"]
    w = b["width"]
    pe = 4 * (1 + 2 * b["pos_xyz_dim"])
    spec: Dict[str, tuple] = {}
    width = pe
    for i in range(b["layers"]):
        if i in b["skips"]:
            width += pe
        _linear(spec, f"xyz_encoding_{i}", width, w)
        width = w
    _linear(spec, "sigma", w, 1)
    _linear(spec, "xyz_encoding_final", w, w)
    dir_in = w + 3 * (1 + 2 * b["pos_dir_dim"]) + b["appearance_dim"]
    spec["embedding_a.weight"] = ((appearance_count, b["appearance_dim"]),
                                  None)
    _linear(spec, "dir_a_encoding", dir_in, w // 2)
    _linear(spec, "rgb", w // 2, 3)
    return spec


def draw_weights(spec: Dict[str, tuple], gen: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """Every leaf of `spec` from one uniform draw on `device`: U(+-1 /
    sqrt(fan_in)) for products and biases, unit-variance entries for the
    appearance table, 1 + U(+-0.1) and U(+-0.1) for a LayerNorm's scale and
    shift. float32, contiguous, each a view of its own copy."""
    total = sum(math.prod(shape) for shape, _ in spec.values())
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, lo = {}, 0
    for name, (shape, fan_in) in spec.items():
        n = math.prod(shape)
        u = flat[lo:lo + n].view(shape)
        lo += n
        if fan_in is None:
            t = u * math.sqrt(3.0)
        elif fan_in == 0:
            t = 1.0 + 0.1 * u
        elif fan_in == -1:
            t = 0.1 * u
        else:
            t = u / math.sqrt(fan_in)
        out[name] = t.clone()
    return out


# -------------------------------------------------------------- layers ---

def freq_encode(x: torch.Tensor, n: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(x, sin(2^0 x), cos(2^0 x), ..., sin(2^(n-1) x), cos(2^(n-1) x)),
    each term over all of x's columns, computed as the configuration
    states it: in `dtype` (its compute type), cos(a) as sin(a + pi/2) with
    pi/2 in that type. Returned in float32."""
    xq = x.to(dtype)
    half_pi = torch.tensor(0.5 * math.pi, dtype=dtype, device=x.device)
    parts = [xq]
    for k in range(n):
        a = xq * (2.0 ** k)
        parts += [torch.sin(a), torch.sin(a + half_pi)]
    return torch.cat(parts, dim=-1).float()


def encoder_dtype(cfg: dict) -> torch.dtype:
    """The configuration's compute type (bf16 under its AMP), in which it
    computes the positional encodings and returns the models' outputs. At
    bf16 the encodings' top bands are decided by the rounding of the
    angles themselves (2^11 x in bf16 is exact, 2^11 x + pi/2 is not), so
    these roundings are part of the configuration's function: the
    reference and its control both compute them so."""
    return torch.bfloat16 if cfg["amp"] else torch.float32


def as_output(t: torch.Tensor, cfg: dict) -> torch.Tensor:
    """A model's outputs (colour and density) in the configuration's
    compute type, as the program returns them (bf16 under AMP), back in
    float32; the gradient passes straight through the rounding."""
    dtype = encoder_dtype(cfg)
    if dtype == torch.float32:
        return t
    return t + (t.detach().to(dtype).float() - t.detach())


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x - 1.0)


def expert_chain(x: torch.Tensor, ws: List[torch.Tensor],
                 bs: List[torch.Tensor], skips, prec: Prec) -> torch.Tensor:
    """One expert's chain on its rows x [n, M]: h = h W_l + b_l, at a skip
    layer the chain's input (or the last skip's output) added first, ReLU
    after every layer but the last."""
    last = len(ws) - 1
    h = xin = x
    for l, (w, b) in enumerate(zip(ws, bs)):
        h = prec.q(prec.q(h) @ prec.q(w) + b)
        if l in skips:
            h = h + xin
            if l < last:
                h = torch.relu(h)
            xin = h
        elif l < last:
            h = torch.relu(h)
    return h


def route(gates: torch.Tensor, capacity_factor: float, prioritized: bool,
          drop: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 routing of gates [S, E] (softmax, float32): (expert [S],
    kept [S] bool, l_aux). With `drop` each expert takes at most
    int(capacity_factor * ceil(S / E)) tokens: in token order, or with
    `prioritized` in order of falling top gate (ties in token order). The
    load-balance loss is E * sum_e(mean gate_e * share_e) as Switch
    defines it: sum over experts of (summed gate) x (tokens routed), times
    E / S^2."""
    s, e = gates.shape
    top, expert = torch.max(gates.detach(), dim=1)
    onehot = F.one_hot(expert, e)
    l_aux = torch.sum(gates.sum(0) * onehot.sum(0).float()) * (e / (s * s))
    if not drop:
        return expert, torch.ones_like(expert, dtype=torch.bool), l_aux
    cap = int(capacity_factor * ((s + e - 1) // e))
    order = (torch.sort(-top, stable=True).indices if prioritized
             else torch.arange(s, device=gates.device))
    queued = torch.cumsum(onehot[order], dim=0) - 1             # [S, E]
    loc = torch.empty_like(expert)
    loc[order] = queued.gather(1, expert[order][:, None])[:, 0]
    return expert, loc < cap, l_aux


def moe_layer(p, x, gate_in, m, drop: bool, prec: Prec):
    """The switch layer: float32 gate on gate_in, top-1 routing, each kept
    token through its expert's chain scaled by its gate; a dropped token
    gives 0. Returns (y [S, M], l_aux)."""
    gates = torch.softmax(gate_in @ p["layer_0.wg.weight"].t(), dim=1)
    expert, kept, l_aux = route(gates, m["capacity_factor"],
                                m["prioritized"], drop)
    g = gates.gather(1, expert[:, None])
    y = torch.zeros_like(x)
    L = m["expert_layers"]
    for e in range(m["experts"]):
        rows = torch.nonzero((expert == e) & kept)[:, 0]
        if rows.numel() == 0:
            continue
        ws = [p[f"layer_0.experts.w{i}"][e] for i in range(L)]
        bs = [p[f"layer_0.experts.b{i}"][e] for i in range(L)]
        out = expert_chain(x[rows], ws, bs, set(m["skips"]), prec)
        y = y.index_add(0, rows, out * g[rows])
    return y, l_aux


def nerf_moe(p, x, sigma_noise, cfg: dict, drop: bool, prec: Prec = FP32):
    """The NeRF-MoE of the configuration on points x [S, xyz (+3 dirs) +1
    appearance index]: (outputs [S, 4] = sigmoid rgb and shifted-softplus
    sigma, moe_loss [1])."""
    m = cfg["model"]
    lin = prec.linear
    enc = encoder_dtype(cfg)
    h = freq_encode(x[:, :3], m["pos_xyz_dim"], enc)
    h = lin(h, p["layer_xyz.fc0.weight"], p["layer_xyz.fc0.bias"])
    gf = torch.relu(lin(h, p["layer_moe_external_gate.fc0.weight"],
                        p["layer_moe_external_gate.fc0.bias"]))
    gf = lin(gf, p["layer_moe_external_gate.fc1.weight"],
             p["layer_moe_external_gate.fc1.bias"])
    gf = F.layer_norm(gf, (gf.shape[-1],), p["layer_gate_input_norm.weight"],
                      p["layer_gate_input_norm.bias"], 1e-5)
    h, l_aux = moe_layer(p, h, gf, m, drop, prec)
    h = torch.relu(h)
    sigma = h @ p["layer_sigma.fc0.weight"].t() + p["layer_sigma.fc0.bias"]
    if sigma_noise is not None:
        sigma = sigma + sigma_noise
    sigma = shifted_softplus(sigma)
    h = lin(h, p["layer_1.fc0.weight"], p["layer_1.fc0.bias"])
    idx = x[:, -1].long()
    h = torch.cat([h, freq_encode(x[:, 3:6], m["pos_dir_dim"], enc),
                   p["embedding_a.weight"][idx]], dim=-1)
    h = torch.relu(lin(h, p["layer_2.fc0.weight"], p["layer_2.fc0.bias"]))
    rgb = prec.q(torch.sigmoid(lin(h, p["layer_color.fc0.weight"],
                                   p["layer_color.fc0.bias"])))
    return as_output(torch.cat([rgb, sigma], dim=-1), cfg), l_aux.reshape(1)


def bg_nerf(p, x, sigma_noise, cfg: dict, prec: Prec = FP32):
    """The dense background NeRF on points x [S, 4 (+3 dirs) +1 index]:
    (outputs [S, 4], an empty moe_loss)."""
    b = cfg["bg_model"]
    lin = prec.linear
    enc = encoder_dtype(cfg)
    pe = freq_encode(x[:, :4], b["pos_xyz_dim"], enc)
    h = pe
    for i in range(b["layers"]):
        if i in b["skips"]:
            h = torch.cat([pe, h], dim=-1)
        h = torch.relu(lin(h, p[f"xyz_encoding_{i}.weight"],
                           p[f"xyz_encoding_{i}.bias"]))
    sigma = h @ p["sigma.weight"].t() + p["sigma.bias"]
    if sigma_noise is not None:
        sigma = sigma + sigma_noise
    sigma = shifted_softplus(sigma)
    idx = x[:, -1].long()
    h2 = torch.cat([lin(h, p["xyz_encoding_final.weight"],
                        p["xyz_encoding_final.bias"]),
                    freq_encode(x[:, 4:7], b["pos_dir_dim"], enc),
                    p["embedding_a.weight"][idx]], dim=-1)
    h2 = torch.relu(lin(h2, p["dir_a_encoding.weight"],
                        p["dir_a_encoding.bias"]))
    rgb = prec.q(torch.sigmoid(lin(h2, p["rgb.weight"], p["rgb.bias"])))
    return as_output(torch.cat([rgb, sigma], dim=-1), cfg), x.new_zeros((0,))
