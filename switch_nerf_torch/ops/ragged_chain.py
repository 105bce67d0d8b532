"""Kernels K1R and K2R: the per-expert MLP chain over expert-sorted rows.

The no-drop dispatch (``models/moe.py`` ``_nodrop_path``) sorts the tokens
by expert and runs each expert's chain on its own rows: the JAX package's
``ExpertMLP.ragged`` (``switch_nerf_tpu/models/experts.py:79``), one
``jax.lax.ragged_dot`` per layer, an XLA op with no Pallas counterpart.
Plain PyTorch has no grouped product that needs no host sync (a loop over
experts reads the counts on the host for every chunk; padding to [E, N, M]
multiplies the work by E), so the card runs hand-written kernels:

K1R (``csrc/ragged_chain.cu``) reads x [N, M], which holds expert e's
rows from off[e] = sum(counts[:e]), with counts [E] int32 on the device
(``csrc/rows.cuh``). A CTA (expert, row block) finds its rows from the
counts and exits when its block starts past them; the grid is sized from
N, so the forward has no host sync and no shape that depends on the data.
Rows come in by a cp.async copy and leave by stores that stop at the
expert's last row. bf16 runs K1's wgmma + TMA design; fp32 (Bungee's
training path, Mission Bay's --no_amp serving at M = 512, where each layer
runs in four passes of 128 output columns) runs on the tensor cores in
split precision, 3xTF32
(``csrc/chain_tf32.cuh``: each operand split into tf32 hi + lo, three
products hi*hi + hi*lo + lo*hi per step, error near fp32's; one TF32
product would miss the fp32 limit), after a step that writes the split
weights into a workspace (``wsplit``). Bound: 2*N*M^2*L operations against
x, W and out (times 3 TF32 products in fp32).

K2R (``csrc/ragged_chain_bwd.cu``) is three deterministic steps on the
same row source: pass 1 recomputes and sweeps each tile into per-expert
workspace segments of whole tiles (``ws_rows`` rows a layer,
bounded from N and E alone); pass 2 cuts every expert's segment into
chunks of 2,048 rows and forms each chunk's partial dW = H^T G and db, one
CTA per (dW tile, chunk, layer), so skewed routing spreads over the card;
a reduction sums each expert's partials in ascending chunk order. No
atomics, the same bits on every run, exact zeros for an expert with no
rows. The partials (``ragged_chain_chunks(N, E)`` of them a layer) are
sized from N and E alone. In fp32 the sweep and pass 2 run in 3xTF32 and
the recompute on the CUDA cores in the plain chain's order, so its ReLU
masks are the plain version's bit for bit.

``ragged_chain`` is differentiable through ``RaggedChainFn`` (forward K1R,
backward K2R). A CPU tensor takes the plain versions (a loop over experts
that reads the counts on the host: the tests' oracle); a CUDA tensor takes
the kernels or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from switch_nerf_torch.ops import _build
from switch_nerf_torch.ops.expert_kernel import (
    check_chain_weights, check_like, check_rows, expert_mlp_chain_bwd_plain,
    expert_mlp_chain_plain, pointers, raise_on_error, skip_mask,
    split_workspace)
from switch_nerf_torch.utils.spans import spanned

__all__ = ["ragged_chain", "ragged_chain_plain", "ragged_chain_bwd_plain",
           "ragged_chain_fwd", "ragged_chain_bwd", "RaggedChainFn"]

# kernel launches since the caller last set them to 0 (read by chip_smoke.py)
ragged_launches = 0       # K1R
ragged_bwd_launches = 0   # K2R

_PROTOTYPES = {
    "ragged_chain_fwd": (ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 6
                         + [ctypes.c_int] * 4
                         + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]),
    "ragged_chain_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_BWD_PROTOTYPES = {
    "ragged_chain_bwd": (ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 13
                         + [ctypes.c_int] * 4
                         + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]),
    "ragged_chain_ws_rows": (ctypes.c_longlong, [ctypes.c_int] * 2),
    "ragged_chain_chunks": (ctypes.c_int, [ctypes.c_int] * 2),
    "ragged_chain_bwd_max_layers": (ctypes.c_int, [ctypes.c_int] * 3),
    "ragged_chain_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _segments(counts: torch.Tensor):
    """(expert, first row, rows) of each expert, counts read on the host."""
    start = 0
    for e, c in enumerate(counts.tolist()):
        yield e, start, c
        start += c


def ragged_chain_plain(x: torch.Tensor, counts: torch.Tensor,
                       ws: torch.Tensor, bs: torch.Tensor,
                       skips: Sequence[int] = ()) -> torch.Tensor:
    """The plain version: each expert's rows through the plain padded chain
    (``expert_mlp_chain_plain``, the kernels' casts), one expert at a time.

    x [N, M] sorted by expert; counts [E] summing to N; ws [L, E, M, M] and
    bs [L, E, 1, M] in x's dtype. Differentiable by autograd."""
    parts = [expert_mlp_chain_plain(x[None, lo:lo + c], ws[:, e:e + 1],
                                    bs[:, e:e + 1], skips)[0]
             for e, lo, c in _segments(counts) if c]
    return torch.cat(parts) if parts else x.clone()


def ragged_chain_bwd_plain(x: torch.Tensor, counts: torch.Tensor,
                           ws: torch.Tensor, bs: torch.Tensor,
                           g: torch.Tensor, skips: Sequence[int] = ()):
    """The plain backward at cotangent g [N, M]: each expert's rows through
    ``expert_mlp_chain_bwd_plain``. Returns (dx in x's dtype, dW [L, E, M, M]
    fp32, db [L, E, 1, M] fp32), an expert's dW and db summed over its own
    rows (zero for an expert with none)."""
    layers, e_num, m = ws.shape[0], ws.shape[1], ws.shape[-1]
    dw = torch.zeros((layers, e_num, m, m), dtype=torch.float32,
                     device=x.device)
    db = torch.zeros((layers, e_num, 1, m), dtype=torch.float32,
                     device=x.device)
    dxs = []
    for e, lo, c in _segments(counts):
        if not c:
            continue
        dx_e, dw_e, db_e = expert_mlp_chain_bwd_plain(
            x[None, lo:lo + c], ws[:, e:e + 1], bs[:, e:e + 1],
            g[None, lo:lo + c], skips)
        dxs.append(dx_e[0])
        dw[:, e:e + 1] = dw_e
        db[:, e:e + 1] = db_e
    dx = torch.cat(dxs) if dxs else torch.zeros_like(x)
    return dx, dw, db


def _check(x: torch.Tensor, counts: torch.Tensor, ws: torch.Tensor,
           bs: torch.Tensor) -> None:
    check_rows(x, "x")
    check_chain_weights(ws, bs, x.dtype, x.device)
    if x.dim() != 2 or ws.shape[-1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match ws "
                         f"{tuple(ws.shape)}")
    if (counts.shape != (ws.shape[1],) or counts.dtype != torch.int32
            or counts.device != x.device or not counts.is_contiguous()):
        raise ValueError(f"counts {tuple(counts.shape)} {counts.dtype} on "
                         f"{counts.device} is not contiguous int32 "
                         f"[{ws.shape[1]}] on {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def ragged_chain_fwd(x: torch.Tensor, counts: torch.Tensor, ws: torch.Tensor,
                     bs: torch.Tensor,
                     skips: Sequence[int] = ()) -> torch.Tensor:
    """K1R (or, for a CPU tensor, the plain version), outside autograd.
    counts must sum to N (the expert sort guarantees it); the kernel reads
    them on the device and trusts them."""
    global ragged_launches
    if x.device.type == "cpu":
        return ragged_chain_plain(x, counts, ws, bs, skips)
    _check(x, counts, ws, bs)
    n, m = x.shape
    layers, e = ws.shape[0], ws.shape[1]
    out = torch.empty_like(x)
    if n == 0:
        return out
    wsplit = split_workspace(ws)
    lib = _build.load("ragged_chain", _PROTOTYPES)
    rc = lib.ragged_chain_fwd(
        x.device.index, x.data_ptr(), counts.data_ptr(), ws.data_ptr(),
        bs.data_ptr(), *pointers([wsplit]), out.data_ptr(), e, n, m, layers,
        skip_mask(skips, layers), int(x.dtype == torch.bfloat16), _stream(x))
    raise_on_error(rc, lib.ragged_chain_error_string)
    ragged_launches += 1
    return out


def ragged_chain_bwd(x: torch.Tensor, counts: torch.Tensor, ws: torch.Tensor,
                     bs: torch.Tensor, g: torch.Tensor,
                     skips: Sequence[int] = ()):
    """K2R (or, for a CPU tensor, the plain backward): the VJP at cotangent
    g [N, M]. Returns (dx, dW fp32, db fp32)."""
    global ragged_bwd_launches
    if x.device.type == "cpu":
        return ragged_chain_bwd_plain(x, counts, ws, bs, g, skips)
    _check(x, counts, ws, bs)
    check_like(g, x, "g")
    n, m = x.shape
    if n == 0:
        raise ValueError("the backward kernel takes N >= 1 rows")
    layers, e = ws.shape[0], ws.shape[1]
    lib = _build.load("ragged_chain_bwd", _BWD_PROTOTYPES)
    index = x.device.index
    bf16 = x.dtype == torch.bfloat16
    limit = lib.ragged_chain_bwd_max_layers(index, m, int(bf16))
    if layers > limit:
        raise ValueError(f"the {x.dtype} backward kernel at M={m} takes up "
                         f"to {limit} layers, got {layers}")
    ws_rows = lib.ragged_chain_ws_rows(n, e)
    chunks = lib.ragged_chain_chunks(n, e)
    f32 = dict(dtype=torch.float32, device=x.device)
    hsave = torch.empty((layers, ws_rows, m), dtype=x.dtype, device=x.device)
    if bf16:
        gsave = torch.empty_like(hsave)
        wsplit = None
    else:   # G_l^T as tf32 hi and lo; W_l split likewise
        gsave = torch.empty((2, layers, m, ws_rows), **f32)
        wsplit = torch.empty((2, layers * e, m, m), **f32)
    dwp = torch.empty((layers, chunks, m, m), **f32)
    dbp = torch.empty((layers, chunks, m), **f32)
    dx = torch.empty_like(x)
    dw = torch.empty((layers, e, m, m), **f32)
    db = torch.empty((layers, e, 1, m), **f32)
    rc = lib.ragged_chain_bwd(
        index, x.data_ptr(), counts.data_ptr(), ws.data_ptr(), bs.data_ptr(),
        g.data_ptr(), dx.data_ptr(), hsave.data_ptr(), gsave.data_ptr(),
        None if bf16 else wsplit.data_ptr(), dwp.data_ptr(), dbp.data_ptr(),
        dw.data_ptr(), db.data_ptr(), e, n, m, layers,
        skip_mask(skips, layers), int(bf16), _stream(x))
    raise_on_error(rc, lib.ragged_chain_bwd_error_string)
    ragged_bwd_launches += 1
    return dx, dw, db


class RaggedChainFn(torch.autograd.Function):
    """The ragged chain with a kernel on each side: forward K1R, backward
    K2R; dW/db come back cast to the parameter dtype."""

    @staticmethod
    def forward(ctx, x, counts, ws, bs, skips):
        ctx.skips = tuple(skips)
        ctx.save_for_backward(x, counts, ws, bs)
        return ragged_chain_fwd(x, counts, ws, bs, skips)

    @staticmethod
    @spanned("moe.experts_bwd")
    def backward(ctx, g):
        x, counts, ws, bs = ctx.saved_tensors
        dx, dw, db = ragged_chain_bwd(x, counts, ws, bs, g.contiguous(),
                                      ctx.skips)
        return dx, None, dw.to(ws.dtype), db.to(bs.dtype), None


def ragged_chain(x: torch.Tensor, counts: torch.Tensor, ws: torch.Tensor,
                 bs: torch.Tensor, skips: Sequence[int] = ()) -> torch.Tensor:
    """L-layer per-expert MLP chain over expert-sorted rows: x [N, M] ->
    [N, M], expert e on rows sum(counts[:e]) .. + counts[e].

    counts [E] int32 on x's device; ws [L, E, M, M] and bs [L, E, 1, M] in
    x's dtype. Differentiable (``RaggedChainFn``) when grad is enabled."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, ws, bs)):
        return RaggedChainFn.apply(x, counts, ws, bs, tuple(skips))
    return ragged_chain_fwd(x, counts, ws, bs, skips)
