"""Kernels K1 and K2: the fused per-expert MLP chain, forward and backward.

K1 replaces ``switch_nerf_tpu/ops/expert_kernel.py:_fwd_call`` (the Pallas
``_fwd_kernel``); source ``csrc/expert_chain.cu`` on ``csrc/chain_sm90.cuh``
(bf16) and ``csrc/chain_tf32.cuh`` (fp32). What bounds it on the card: at the
Building shape (E8 C4096 M256 L7, bf16) one launch does 2*E*C*M^2*L = 30.1
GFLOP against ~41 MB of x, W and out, ~730 FLOP per byte, far above the
H100's ~295 FLOP/B ridge: it is bound by tensor-core operations. The bf16
design keeps each 128-row tile of an expert and its skip input in shared
memory across all L layers (device memory sees x once and out once), feeds
the tensor cores with wgmma from two consumer warpgroups of 64 rows each,
and has one producer warp stream W through a ring of TMA loads that runs
ahead across layers; input and output move by TMA over [E, C, M] tensor
maps that zero-fill and clip the ragged C edge. fp32 runs K1R's design on
the tensor cores in split precision, 3xTF32 (``csrc/chain_tf32.cuh`` with
the in-place row source): each operand split into tf32 hi + lo, three TF32
products hi*hi + hi*lo + lo*hi per product, each 16-k stage summed apart
and added in fp32 (error near fp32's; one TF32 product would miss the fp32
limit), on 64-row tiles, after a step that writes the split weights into a
workspace (``split_workspace``) allocated here.

K2 replaces ``_bwd_call`` (the Pallas ``_bwd_kernel``); source
``csrc/expert_chain_bwd.cu`` on ``csrc/chain_bwd_sm90.cuh`` (bf16) and
``csrc/chain_tf32.cuh`` (fp32). The gradient needs the dx and dW products,
4*E*C*M^2*L = 60.1 GFLOP at the Building shape against ~65 MB of x, g, dx
and fp32 dW: bound by tensor-core operations (the recompute is the kernel's
own choice and not in the bound). The TPU kernel adds each C block's dW
into a revisited output block, which needs the TPU's in-order grid; on the
card a first pass recomputes the forward and runs the reverse sweep per
128-row tile (K1's mainloop), sending each layer's input H_l and post-mask
gradient G_l to workspaces by TMA stores and keeping the ReLU masks as bits
in shared memory; a second pass forms dW = H_l^T G_l and db with fp32
accumulators over all C inside one CTA per 128 x min(M, 256) output tile:
deterministic, no atomics. The bf16 pass 1 holds L - 1 layers of masks in
shared memory, so on an H100 it takes up to 8 layers at M = 256 and 7 at
M = 512 (``bwd_max_layers``); more raise. fp32 runs K2R's design on the
tensor cores in split precision, 3xTF32 (``csrc/chain_tf32.cuh`` with the
in-place row source): 64-row tiles whose recompute runs on the CUDA cores
in the plain chain's summation order, so the ReLU masks are the plain
version's bit for bit; the reverse sweep and the dW pass in 3xTF32 (three
TF32 products per product, error near fp32's; one TF32 product would miss
the fp32 limit); dW over 2,048-row chunks of each expert, whose partial
sums a last step adds in ascending order (deterministic, no atomics). Its
masks are read back from the recomputed activations in device memory, so
it takes 32 layers at every width. Its workspaces (``bwd_buffers``) are
allocated here.

Widths: M = 64, 128, 256 and 512 (Mission Bay's trunk) in both dtypes.
In bf16 a CTA owns 64 rows at M = 512 and each consumer warpgroup half
the columns, since wgmma's widest product is 256 columns. In fp32 the
forward and the backward run each layer in four passes of 128 output
columns at M = 512 (``TCfg::kPasses``).

``expert_mlp_chain`` is differentiable through ``ExpertChainFn`` (forward
K1, backward K2). A CPU tensor takes the plain PyTorch versions; a CUDA
tensor takes the kernels or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from switch_nerf_torch.ops import _build
from switch_nerf_torch.utils.spans import spanned

__all__ = ["expert_mlp_chain", "expert_mlp_chain_plain",
           "expert_mlp_chain_bwd", "expert_mlp_chain_bwd_plain",
           "ExpertChainFn", "KERNEL_WIDTHS"]

KERNEL_WIDTHS = (64, 128, 256, 512)   # model widths of the kernels
_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since the caller last set them to 0 (read by chip_smoke.py)
launches = 0          # K1
bwd_launches = 0      # K2


def _relu_skip(h: torch.Tensor, xin: torch.Tensor, l: int, layers: int,
               skips) -> Tuple[torch.Tensor, torch.Tensor]:
    """Skip add and ReLU after layer l's bias (ExpertMLP._skip_act)."""
    last = l == layers - 1
    if l in skips:
        h = h + xin
        if not last:
            h = torch.relu(h)
        xin = h
    elif not last:
        h = torch.relu(h)
    return h, xin


def expert_mlp_chain_plain(x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor,
                           skips: Sequence[int] = ()) -> torch.Tensor:
    """The plain PyTorch chain: one matmul per layer, with the kernel's casts.

    x [E, C, M]; ws [L, E, M, M]; bs [L, E, 1, M], all one dtype. The
    product comes back in x's dtype (fp32 accumulation) before the bias.
    """
    skips = set(skips)
    layers = ws.shape[0]
    h = xin = x
    for l in range(layers):
        h, xin = _relu_skip(torch.matmul(h, ws[l]) + bs[l], xin, l, layers,
                            skips)
    return h


def expert_mlp_chain_bwd_plain(x: torch.Tensor, ws: torch.Tensor,
                               bs: torch.Tensor, g: torch.Tensor,
                               skips: Sequence[int] = ()):
    """The plain backward, step by step as the TPU ``_bwd_kernel``:
    recompute the stack, then the reverse sweep with each layer's product
    cast to the input dtype and the ReLU masks taken from the
    post-activation outputs. Returns (dx in x's dtype, dW [L, E, M, M] fp32,
    db [L, E, 1, M] fp32), dW and db summed over C in fp32."""
    skips = set(skips)
    layers = ws.shape[0]
    hs = []                                   # hs[l]: input of layer l
    h = xin = x
    for l in range(layers):
        hs.append(h)
        h, xin = _relu_skip(torch.matmul(h, ws[l]) + bs[l], xin, l, layers,
                            skips)
    hs.append(h)
    gh, gxin = g, torch.zeros_like(g)
    dws, dbs = [None] * layers, [None] * layers
    for l in range(layers - 1, -1, -1):
        gl = gh
        last = l == layers - 1
        if l in skips:
            gl = gl + gxin
        if not last:
            gl = gl * (hs[l + 1] > 0).to(gl.dtype)
        if l in skips:
            gxin = gl
        dws[l] = torch.matmul(hs[l].float().transpose(1, 2), gl.float())
        dbs[l] = gl.float().sum(dim=1, keepdim=True)
        gh = torch.matmul(gl, ws[l].transpose(1, 2))
    return gh + gxin, torch.stack(dws), torch.stack(dbs)


def skip_mask(skips: Sequence[int], layers: int) -> int:
    mask = 0
    for s in skips:
        if not 0 <= s < layers:
            raise ValueError(f"skip layer {s} outside 0..{layers - 1}")
        mask |= 1 << s
    return mask


def check_chain_weights(ws: torch.Tensor, bs: torch.Tensor, dtype,
                        device) -> None:
    """Raise unless ws [L, E, M, M] / bs [L, E, 1, M] suit the kernel."""
    if dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    layers, e, m = ws.shape[0], ws.shape[1], ws.shape[-1]
    if ws.shape != (layers, e, m, m) or bs.shape != (layers, e, 1, m):
        raise ValueError(f"weights {tuple(ws.shape)} / biases "
                         f"{tuple(bs.shape)} are not [L,E,M,M] / [L,E,1,M]")
    if m not in KERNEL_WIDTHS:
        raise ValueError(f"kernel widths are {KERNEL_WIDTHS}, got M={m}")
    if not 1 <= layers <= 32:
        raise ValueError(f"kernel takes 1..32 layers, got {layers}")
    for name, t in (("ws", ws), ("bs", bs)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, activations are {dtype}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, activations on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_rows(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA or CPU tensor, got {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check_like(t: torch.Tensor, ref: torch.Tensor, name: str) -> None:
    """Raise unless t matches ref's shape, dtype and device (and is laid
    out as check_rows asks)."""
    if t.shape != ref.shape or t.dtype != ref.dtype or t.device != ref.device:
        raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} "
                         f"does not match {tuple(ref.shape)} {ref.dtype} on "
                         f"{ref.device}")
    check_rows(t, name)


def raise_on_error(rc: int, error_string) -> None:
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel launch failed: {error_string(rc).decode()} ({rc})")


def bwd_buffers(lib, name: str, layers: int, e: int, c: int, m: int, dtype,
                device):
    """K2/K4's allocations, in the order of the C entry points: the H and G
    workspaces, the split weights and the dW pass's partial sums (fp32
    only, else None), then dW [L, E, M, M] and db [L, E, 1, M] in fp32.
    bf16: H and G [L, E, C, M]. fp32 (``csrc/chain_tf32.cuh``): H
    [L, ws_rows, M] and G_l^T as tf32 hi and lo [2, L, M, ws_rows], ws_rows
    = E x C rounded up to whole 64-row tiles (``<name>_ws_rows``); W split
    likewise [2, L*E, M, M]; the partials [L, chunks, M, M] and
    [L, chunks, M], chunks = E x ceil(C / 2048) (``<name>_chunks``)."""
    f32 = dict(dtype=torch.float32, device=device)
    dw = torch.empty((layers, e, m, m), **f32)
    db = torch.empty((layers, e, 1, m), **f32)
    if dtype == torch.bfloat16:
        work = (layers, e, c, m)
        return (torch.empty(work, dtype=dtype, device=device),
                torch.empty(work, dtype=dtype, device=device), None, None,
                None, dw, db)
    rows = getattr(lib, f"{name}_ws_rows")(e, c)
    chunks = getattr(lib, f"{name}_chunks")(e, c)
    return (torch.empty((layers, rows, m), **f32),
            torch.empty((2, layers, m, rows), **f32),
            torch.empty((2, layers * e, m, m), **f32),
            torch.empty((layers, chunks, m, m), **f32),
            torch.empty((layers, chunks, m), **f32), dw, db)


def split_workspace(ws: torch.Tensor):
    """The fp32 forwards' workspace (K1, K3, K1R: ``wsplit``), the split
    weights W_l^T as tf32 hi and lo [2, L*E, M, M]; None in bf16."""
    if ws.dtype == torch.bfloat16:
        return None
    layers, e, m = ws.shape[0], ws.shape[1], ws.shape[-1]
    return torch.empty((2, layers * e, m, m), dtype=torch.float32,
                       device=ws.device)


def pointers(tensors) -> list:
    return [None if t is None else t.data_ptr() for t in tensors]


_PROTOTYPES = {
    "expert_chain_fwd": (ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 4
                         + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]),
    "expert_chain_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_BWD_PROTOTYPES = {
    "expert_chain_bwd": (ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 12
                         + [ctypes.c_int] * 4
                         + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]),
    "expert_chain_bwd_recompute": (
        ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 12
        + [ctypes.c_int] * 4 + [ctypes.c_uint, ctypes.c_void_p]),
    "expert_chain_bwd_ws_rows": (ctypes.c_longlong, [ctypes.c_int] * 2),
    "expert_chain_bwd_chunks": (ctypes.c_int, [ctypes.c_int] * 2),
    "expert_chain_bwd_max_layers": (ctypes.c_int, [ctypes.c_int] * 3),
    "expert_chain_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check_x(x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> None:
    check_rows(x, "x")
    check_chain_weights(ws, bs, x.dtype, x.device)
    if x.dim() != 3 or ws.shape[1] != x.shape[0] or ws.shape[-1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} does not match ws "
                         f"{tuple(ws.shape)}")


def expert_mlp_chain_fwd(x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor,
                         skips: Sequence[int] = ()) -> torch.Tensor:
    """K1 (or, for a CPU tensor, the plain chain), outside autograd."""
    global launches
    if x.device.type == "cpu":
        return expert_mlp_chain_plain(x, ws, bs, skips)
    _check_x(x, ws, bs)
    e, c, m = x.shape
    layers = ws.shape[0]
    out = torch.empty_like(x)
    wsplit = split_workspace(ws)
    lib = _build.load("expert_chain", _PROTOTYPES)
    rc = lib.expert_chain_fwd(
        x.device.index, x.data_ptr(), ws.data_ptr(), bs.data_ptr(),
        *pointers([wsplit]), out.data_ptr(), e, c, m, layers,
        skip_mask(skips, layers), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(rc, lib.expert_chain_error_string)
    launches += 1
    return out


def bwd_max_layers(device: torch.device, m: int, dtype) -> int:
    """The most layers K2 takes at width m on this CUDA device (bf16: the
    ReLU masks of L - 1 layers share pass 1's shared memory)."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    lib = _build.load("expert_chain_bwd", _BWD_PROTOTYPES)
    return lib.expert_chain_bwd_max_layers(index, m,
                                           int(dtype == torch.bfloat16))


def expert_mlp_chain_bwd(x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor,
                         g: torch.Tensor, skips: Sequence[int] = ()):
    """K2 (or, for a CPU tensor, the plain backward): the chain's VJP at
    cotangent g [E, C, M]. Returns (dx, dW fp32, db fp32)."""
    global bwd_launches
    if x.device.type == "cpu":
        return expert_mlp_chain_bwd_plain(x, ws, bs, g, skips)
    _check_x(x, ws, bs)
    check_like(g, x, "g")
    e, c, m = x.shape
    if c == 0:
        raise ValueError("the backward kernel takes C >= 1")
    layers = ws.shape[0]
    limit = bwd_max_layers(x.device, m, x.dtype)
    if layers > limit:
        raise ValueError(f"the {x.dtype} backward kernel at M={m} takes up "
                         f"to {limit} layers, got {layers}")
    dx = torch.empty_like(x)
    lib = _build.load("expert_chain_bwd", _BWD_PROTOTYPES)
    bufs = bwd_buffers(lib, "expert_chain_bwd", layers, e, c, m, x.dtype,
                       x.device)
    rc = lib.expert_chain_bwd(
        x.device.index, x.data_ptr(), ws.data_ptr(), bs.data_ptr(),
        g.data_ptr(), dx.data_ptr(), *pointers(bufs), e, c, m, layers,
        skip_mask(skips, layers), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(rc, lib.expert_chain_bwd_error_string)
    bwd_launches += 1
    return dx, bufs[-2], bufs[-1]


def expert_mlp_chain_bwd_recompute(x: torch.Tensor, ws: torch.Tensor,
                                   bs: torch.Tensor, g: torch.Tensor,
                                   skips: Sequence[int] = ()) -> None:
    """fp32 K2's weight split and pass 1 stopped after its recompute, on
    the card: the recompute's time alone, for chip_smoke.py's profiled
    split of K2. Returns nothing (its outputs are no gradient) and counts
    no launch."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("the recompute alone runs fp32 on the card")
    _check_x(x, ws, bs)
    check_like(g, x, "g")
    e, c, m = x.shape
    layers = ws.shape[0]
    lib = _build.load("expert_chain_bwd", _BWD_PROTOTYPES)
    bufs = bwd_buffers(lib, "expert_chain_bwd", layers, e, c, m, x.dtype,
                       x.device)
    rc = lib.expert_chain_bwd_recompute(
        x.device.index, x.data_ptr(), ws.data_ptr(), bs.data_ptr(),
        g.data_ptr(), torch.empty_like(x).data_ptr(), *pointers(bufs), e, c,
        m, layers, skip_mask(skips, layers),
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(rc, lib.expert_chain_bwd_error_string)


class ExpertChainFn(torch.autograd.Function):
    """The chain with a kernel on each side, as the JAX custom VJP
    (``expert_kernel.py:193-220``): forward K1, backward K2, and dW/db come
    back cast to the parameter dtype."""

    @staticmethod
    def forward(ctx, x, ws, bs, skips):
        ctx.skips = tuple(skips)
        ctx.save_for_backward(x, ws, bs)
        return expert_mlp_chain_fwd(x, ws, bs, skips)

    @staticmethod
    @spanned("moe.experts_bwd")
    def backward(ctx, g):
        x, ws, bs = ctx.saved_tensors
        dx, dw, db = expert_mlp_chain_bwd(x, ws, bs, g.contiguous(),
                                          ctx.skips)
        return dx, dw.to(ws.dtype), db.to(bs.dtype), None


def expert_mlp_chain(x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor,
                     skips: Sequence[int] = ()) -> torch.Tensor:
    """Fused L-layer per-expert MLP chain: x [E, C, M] -> [E, C, M].

    ws [L, E, M, M] and bs [L, E, 1, M] share x's dtype (bf16 under AMP).
    Differentiable (``ExpertChainFn``) when grad is enabled.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, ws, bs)):
        return ExpertChainFn.apply(x, ws, bs, tuple(skips))
    return expert_mlp_chain_fwd(x, ws, bs, skips)
