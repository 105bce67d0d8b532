"""Kernel K3: fused dispatch gather + expert chain (top-1, padded), forward.

Replaces ``switch_nerf_tpu/ops/fused_dispatch.py:_fwd_call`` (the Pallas
``_fwd_kernel``, ``_gather_block`` and ``_chain_fwd_from``). Source:
``csrc/chain.cuh`` + ``csrc/fused_dispatch.cu``.

Computes chain(dispatch(tokens)) without the [E, C, M] dispatch buffer:
each CTA loads its own slot->token indices and reads the token rows
straight from device memory, then runs K1's chain on them. Empty slots
point at a zero row appended to the tokens, so the chain sees zeros there,
as over the zero-padded dispatch buffer. What bounds it is K1's: tensor-core
operations (the gather adds one read of the kept token rows). The TPU
kernel's 8-row-aligned mask-select gather has no counterpart on the card:
any row address is a legal load here.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the
kernel or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from switch_nerf_torch.ops import _build
from switch_nerf_torch.ops.expert_kernel import (
    KERNEL_WIDTHS, check_chain_weights, check_rows, expert_mlp_chain_plain,
    raise_on_error, skip_mask)

__all__ = ["fused_dispatch_chain", "fused_dispatch_chain_plain",
           "fused_slot_map", "fused_supported"]

# kernel launches since the caller last set it to 0 (read by chip_smoke.py)
launches = 0


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


def fused_dispatch_chain_plain(tokens_ext: torch.Tensor,
                               stt_eff: torch.Tensor, ws: torch.Tensor,
                               bs: torch.Tensor,
                               skips: Sequence[int] = ()) -> torch.Tensor:
    """The plain version: an index gather, then the plain chain."""
    e, m = ws.shape[1], tokens_ext.shape[-1]
    x = tokens_ext[stt_eff.long()].reshape(e, -1, m)
    return expert_mlp_chain_plain(x, ws, bs, skips)


_PROTOTYPES = {
    "fused_dispatch_fwd": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int] * 4
        + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]),
    "fused_dispatch_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def fused_dispatch_chain(tokens_ext: torch.Tensor, stt_eff: torch.Tensor,
                         ws: torch.Tensor, bs: torch.Tensor,
                         skips: Sequence[int] = ()) -> torch.Tensor:
    """chain(dispatch(tokens)) -> [E, C, M].

    tokens_ext: [S', M] tokens plus one zero row (the empty-slot target)
    stt_eff:    [E*C] int32 slot->token map into tokens_ext, every entry in
                [0, S'). On the card an entry out of range stops the kernel
                with a device-side assert, as PyTorch's index kernels do.
    ws / bs:    [L, E, M, M] / [L, E, 1, M] in the tokens' dtype
    """
    global launches
    if tokens_ext.device.type == "cpu":
        return fused_dispatch_chain_plain(tokens_ext, stt_eff, ws, bs, skips)
    check_rows(tokens_ext, "tokens_ext")
    check_chain_weights(ws, bs, tokens_ext.dtype, tokens_ext.device)
    s_ext, m = tokens_ext.shape
    layers, e = ws.shape[0], ws.shape[1]
    if ws.shape[-1] != m:
        raise ValueError(f"tokens width {m} does not match ws "
                         f"{tuple(ws.shape)}")
    if (stt_eff.dtype != torch.int32 or stt_eff.dim() != 1
            or stt_eff.device != tokens_ext.device
            or not stt_eff.is_contiguous() or stt_eff.numel() % e):
        raise ValueError("stt_eff must be a contiguous int32 [E*C] tensor on "
                         "the tokens' device")
    c = stt_eff.numel() // e
    out = torch.empty((e, c, m), dtype=tokens_ext.dtype,
                      device=tokens_ext.device)
    lib = _build.load("fused_dispatch", _PROTOTYPES)
    rc = lib.fused_dispatch_fwd(
        tokens_ext.device.index, tokens_ext.data_ptr(), stt_eff.data_ptr(),
        s_ext, ws.data_ptr(), bs.data_ptr(), out.data_ptr(), e, c, m, layers,
        skip_mask(skips, layers), int(tokens_ext.dtype == torch.bfloat16),
        torch.cuda.current_stream(tokens_ext.device).cuda_stream)
    raise_on_error(rc, lib.fused_dispatch_error_string)
    launches += 1
    return out
