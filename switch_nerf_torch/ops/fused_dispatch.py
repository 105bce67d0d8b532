"""Kernels K3 and K4: fused dispatch gather + expert chain (top-1, padded),
forward and backward.

K3 replaces ``switch_nerf_tpu/ops/fused_dispatch.py:_fwd_call`` (the Pallas
``_fwd_kernel``, ``_gather_block`` and ``_chain_fwd_from``); source
``csrc/fused_dispatch.cu`` on ``csrc/chain_sm90.cuh`` (bf16) and
``csrc/chain_tf32.cuh`` (fp32: K1's 3xTF32 design, its producer gathering
the token rows by ``cp.async``). K4 replaces ``_bwd_call`` (the Pallas
``_bwd_kernel``); source ``csrc/fused_dispatch_bwd.cu`` on
``csrc/chain_bwd_sm90.cuh`` (bf16) and ``csrc/chain_tf32.cuh`` (fp32: K2's
3xTF32 design, with the same gather).

K3 computes chain(dispatch(tokens)) without the [E, C, M] dispatch buffer:
each CTA loads its own slot->token indices and reads the token rows
straight from device memory, then runs K1's chain on them. Empty slots
point at a zero row appended to the tokens, so the chain sees zeros there,
as over the zero-padded dispatch buffer. K4 gathers the same rows again and
runs K2's two passes on them (recompute + reverse sweep, then dW/db over
all C per output tile), returning d(dispatched) [E, C, M]; the VJP turns
that into d(tokens) with a gather over the token->slot map outside the
kernel, as the JAX package's ``_fused_bwd`` does. What bounds them is
K1's and K2's: tensor-core operations (the gather adds one read of the kept
token rows). In bf16 they are K1 and K2 with another producer: TMA cannot
gather rows, so the producer warpgroup copies each 128-row tile's token
rows with ``cp.async`` (one 16-byte chunk a lane) into the swizzled layout
that wgmma reads, zero-filling rows past C, and everything after the input
tile is K1's and K2's. K4 inherits K2's layer limit (bf16 at M = 256 on an
H100: 8; fp32: 32). The TPU kernel's 8-row-aligned mask-select gather has no
counterpart on the card: any row address is a legal load here.

``fused_dispatch_chain`` is differentiable through ``FusedDispatchFn``. A
CPU tensor takes the plain PyTorch versions; a CUDA tensor takes the
kernels or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from switch_nerf_torch.ops import _build
from switch_nerf_torch.ops.expert_kernel import (
    KERNEL_WIDTHS, bwd_buffers, check_chain_weights, check_like, check_rows,
    expert_mlp_chain_bwd_plain, expert_mlp_chain_plain, pointers,
    raise_on_error, skip_mask, split_workspace)
from switch_nerf_torch.utils.spans import spanned

__all__ = ["fused_dispatch_chain", "fused_dispatch_chain_plain",
           "fused_dispatch_chain_bwd", "fused_dispatch_chain_bwd_plain",
           "FusedDispatchFn", "fused_slot_map", "fused_supported"]

# kernel launches since the caller last set them to 0 (read by chip_smoke.py)
launches = 0          # K3
bwd_launches = 0      # K4


def fused_supported(tokens_shape, num_experts: int, capacity: int,
                    layer_num: int) -> bool:
    """Static shape conditions of the card's kernel.

    The TPU version also asks that the whole token array fit in VMEM and
    that the capacity be a multiple of 8 (Mosaic's aligned row groups).
    Neither holds here: the card's kernel reads token rows straight from
    device memory, and it masks a ragged capacity edge itself. What remains
    is the kernel's own limits: its built widths, 1..32 layers, and int32
    row and slot indices.
    """
    s, m = tokens_shape
    return (m in KERNEL_WIDTHS and 1 <= layer_num <= 32
            and s + 1 < 2 ** 31 and num_experts * capacity < 2 ** 31)


def fused_slot_map(slot_to_token: torch.Tensor, filled: torch.Tensor,
                   num_tokens: int) -> torch.Tensor:
    """The kernel's int32 [E*C] slot->token map: empty slots point at the
    zero row appended after the `num_tokens` tokens."""
    return torch.where(filled, slot_to_token,
                       torch.full_like(slot_to_token, num_tokens)) \
        .to(torch.int32)


def _gather(tokens_ext: torch.Tensor, stt_eff: torch.Tensor,
            num_experts: int) -> torch.Tensor:
    return tokens_ext[stt_eff.long()].reshape(num_experts, -1,
                                              tokens_ext.shape[-1])


def fused_dispatch_chain_plain(tokens_ext: torch.Tensor,
                               stt_eff: torch.Tensor, ws: torch.Tensor,
                               bs: torch.Tensor,
                               skips: Sequence[int] = ()) -> torch.Tensor:
    """The plain version: an index gather, then the plain chain."""
    return expert_mlp_chain_plain(_gather(tokens_ext, stt_eff, ws.shape[1]),
                                  ws, bs, skips)


def fused_dispatch_chain_bwd_plain(tokens_ext: torch.Tensor,
                                   stt_eff: torch.Tensor, ws: torch.Tensor,
                                   bs: torch.Tensor, g: torch.Tensor,
                                   skips: Sequence[int] = ()):
    """The plain backward: gather again, recompute, reverse sweep. Returns
    (d(dispatched) [E, C, M], dW fp32, db fp32)."""
    return expert_mlp_chain_bwd_plain(
        _gather(tokens_ext, stt_eff, ws.shape[1]), ws, bs, g, skips)


_PROTOTYPES = {
    "fused_dispatch_fwd": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]),
    "fused_dispatch_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_BWD_PROTOTYPES = {
    "fused_dispatch_bwd": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 11
        + [ctypes.c_int] * 4
        + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]),
    "fused_dispatch_bwd_ws_rows": (ctypes.c_longlong, [ctypes.c_int] * 2),
    "fused_dispatch_bwd_chunks": (ctypes.c_int, [ctypes.c_int] * 2),
    "fused_dispatch_bwd_max_layers": (ctypes.c_int, [ctypes.c_int] * 3),
    "fused_dispatch_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check_inputs(tokens_ext: torch.Tensor, stt_eff: torch.Tensor,
                  ws: torch.Tensor, bs: torch.Tensor) -> int:
    """Raise on what the kernels do not take; returns the capacity C."""
    check_rows(tokens_ext, "tokens_ext")
    check_chain_weights(ws, bs, tokens_ext.dtype, tokens_ext.device)
    e = ws.shape[1]
    if tokens_ext.dim() != 2 or ws.shape[-1] != tokens_ext.shape[1]:
        raise ValueError(f"tokens {tuple(tokens_ext.shape)} do not match ws "
                         f"{tuple(ws.shape)}")
    if (stt_eff.dtype != torch.int32 or stt_eff.dim() != 1
            or stt_eff.device != tokens_ext.device
            or not stt_eff.is_contiguous() or stt_eff.numel() % e):
        raise ValueError("stt_eff must be a contiguous int32 [E*C] tensor on "
                         "the tokens' device")
    return stt_eff.numel() // e


def fused_dispatch_chain_fwd(tokens_ext: torch.Tensor, stt_eff: torch.Tensor,
                             ws: torch.Tensor, bs: torch.Tensor,
                             skips: Sequence[int] = ()) -> torch.Tensor:
    """K3 (or, for a CPU tensor, the plain version), outside autograd:
    chain(dispatch(tokens)) -> [E, C, M].

    tokens_ext: [S', M] tokens plus one zero row (the empty-slot target)
    stt_eff:    [E*C] int32 slot->token map into tokens_ext, every entry in
                [0, S'). On the card an entry out of range stops the kernel
                with a device-side assert, as PyTorch's index kernels do.
    ws / bs:    [L, E, M, M] / [L, E, 1, M] in the tokens' dtype
    """
    global launches
    if tokens_ext.device.type == "cpu":
        return fused_dispatch_chain_plain(tokens_ext, stt_eff, ws, bs, skips)
    c = _check_inputs(tokens_ext, stt_eff, ws, bs)
    s_ext, m = tokens_ext.shape
    layers, e = ws.shape[0], ws.shape[1]
    out = torch.empty((e, c, m), dtype=tokens_ext.dtype,
                      device=tokens_ext.device)
    wsplit = split_workspace(ws)
    lib = _build.load("fused_dispatch", _PROTOTYPES)
    rc = lib.fused_dispatch_fwd(
        tokens_ext.device.index, tokens_ext.data_ptr(), stt_eff.data_ptr(),
        s_ext, ws.data_ptr(), bs.data_ptr(), *pointers([wsplit]),
        out.data_ptr(), e, c, m, layers, skip_mask(skips, layers),
        int(tokens_ext.dtype == torch.bfloat16),
        torch.cuda.current_stream(tokens_ext.device).cuda_stream)
    raise_on_error(rc, lib.fused_dispatch_error_string)
    launches += 1
    return out


def fused_dispatch_chain_bwd(tokens_ext: torch.Tensor, stt_eff: torch.Tensor,
                             ws: torch.Tensor, bs: torch.Tensor,
                             g: torch.Tensor, skips: Sequence[int] = ()):
    """K4 (or, for a CPU tensor, the plain backward) at cotangent g
    [E, C, M]: returns (d(dispatched) [E, C, M], dW fp32, db fp32)."""
    global bwd_launches
    if tokens_ext.device.type == "cpu":
        return fused_dispatch_chain_bwd_plain(tokens_ext, stt_eff, ws, bs, g,
                                              skips)
    c = _check_inputs(tokens_ext, stt_eff, ws, bs)
    s_ext, m = tokens_ext.shape
    layers, e = ws.shape[0], ws.shape[1]
    dxd = torch.empty((e, c, m), dtype=tokens_ext.dtype,
                      device=tokens_ext.device)
    check_like(g, dxd, "g")
    if c == 0:
        raise ValueError("the backward kernel takes C >= 1")
    is_bf16 = int(tokens_ext.dtype == torch.bfloat16)
    lib = _build.load("fused_dispatch_bwd", _BWD_PROTOTYPES)
    limit = lib.fused_dispatch_bwd_max_layers(tokens_ext.device.index, m,
                                              is_bf16)
    if layers > limit:
        raise ValueError(f"the {tokens_ext.dtype} backward kernel at M={m} "
                         f"takes up to {limit} layers, got {layers}")
    bufs = bwd_buffers(lib, "fused_dispatch_bwd", layers, e, c, m,
                       tokens_ext.dtype, tokens_ext.device)
    rc = lib.fused_dispatch_bwd(
        tokens_ext.device.index, tokens_ext.data_ptr(), stt_eff.data_ptr(),
        s_ext, ws.data_ptr(), bs.data_ptr(), g.data_ptr(), dxd.data_ptr(),
        *pointers(bufs), e, c, m, layers, skip_mask(skips, layers), is_bf16,
        torch.cuda.current_stream(tokens_ext.device).cuda_stream)
    raise_on_error(rc, lib.fused_dispatch_bwd_error_string)
    bwd_launches += 1
    return dxd, bufs[-2], bufs[-1]


class FusedDispatchFn(torch.autograd.Function):
    """chain(dispatch(tokens)) with K3 forward and K4 backward, as the JAX
    custom VJP (``fused_dispatch.py:254-294``). d(tokens) is d(dispatched)
    gathered back by the token->slot map (the slot map is a partial
    permutation for top-1) and masked by ``kept``: plain index ops outside
    the kernel, as in JAX."""

    @staticmethod
    def forward(ctx, tokens_ext, stt_eff, ws, bs, slot, kept, skips):
        ctx.skips = tuple(skips)
        ctx.save_for_backward(tokens_ext, stt_eff, ws, bs, slot, kept)
        return fused_dispatch_chain_fwd(tokens_ext, stt_eff, ws, bs, skips)

    @staticmethod
    @spanned("moe.experts_bwd")
    def backward(ctx, g):
        tokens_ext, stt_eff, ws, bs, slot, kept = ctx.saved_tensors
        dxd, dw, db = fused_dispatch_chain_bwd(tokens_ext, stt_eff, ws, bs,
                                               g.contiguous(), ctx.skips)
        flat = dxd.reshape(-1, dxd.shape[-1])
        flat_ext = torch.cat([flat, flat.new_zeros((1, flat.shape[-1]))])
        rows = flat_ext[slot.long()]                               # [S', M]
        d_tokens = rows * kept[:, None].to(rows.dtype)
        return (d_tokens.to(tokens_ext.dtype), None, dw.to(ws.dtype),
                db.to(bs.dtype), None, None, None)


def fused_dispatch_chain(tokens_ext: torch.Tensor, stt_eff: torch.Tensor,
                         ws: torch.Tensor, bs: torch.Tensor,
                         slot: torch.Tensor, kept: torch.Tensor,
                         skips: Sequence[int] = ()) -> torch.Tensor:
    """chain(dispatch(tokens)) -> [E, C, M], with the JAX signature.

    tokens_ext: [S + 1, M] tokens plus ONE zero row, the empty-slot target.
                (The JAX package pads to a multiple of 8 rows because Mosaic
                loads aligned 8-row groups; the card's kernels load any row,
                so the port keeps the single zero row.)
    stt_eff:    [E*C] int32 slot->token map; empty slots point at row S
    ws / bs:    [L, E, M, M] / [L, E, 1, M] in the tokens' dtype
    slot:       [S + 1] token->slot map (== E*C for dropped tokens and the
                zero row): drives d(tokens) in the backward
    kept:       [S + 1] bool
    Differentiable (``FusedDispatchFn``) when grad is enabled.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (tokens_ext, ws, bs)):
        return FusedDispatchFn.apply(tokens_ext, stt_eff, ws, bs, slot, kept,
                                     tuple(skips))
    return fused_dispatch_chain_fwd(tokens_ext, stt_eff, ws, bs, skips)
