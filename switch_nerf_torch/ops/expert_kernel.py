"""Kernel K1: the fused per-expert MLP chain, forward.

Replaces ``switch_nerf_tpu/ops/expert_kernel.py:_fwd_call`` (the Pallas
``_fwd_kernel``). Source: ``csrc/chain.cuh`` + ``csrc/expert_chain.cu``.

What bounds it on the card: at the Building eval shape (E8 C4096 M256 L7,
bf16) one launch does 2*E*C*M^2*L = 30.1 GFLOP against ~41 MB of x, W and
out, ~730 FLOP per byte, far above the H100's ~295 FLOP/B ridge: it is
bound by tensor-core operations. The design keeps each (expert, row block)'s
activations and skip input in shared memory across all L layers, so device
memory sees x once and out once instead of once per layer, and feeds the
tensor cores through WMMA (mma.sync) with fp32 accumulators. W_l is staged
through shared memory tile by tile, unpipelined: wgmma/TMA and a load
pipeline are later work.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the
kernel or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from switch_nerf_torch.ops import _build

__all__ = ["expert_mlp_chain", "expert_mlp_chain_plain", "KERNEL_WIDTHS"]

KERNEL_WIDTHS = (64, 128, 256)    # model widths the kernel is built for
_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since the caller last set it to 0 (read by chip_smoke.py)
launches = 0


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
        h = torch.matmul(h, ws[l]) + bs[l]
        last = l == layers - 1
        if l in skips:
            h = h + xin
            if not last:
                h = torch.relu(h)
            xin = h
        elif not last:
            h = torch.relu(h)
    return h


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


def raise_on_error(rc: int, error_string) -> None:
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel launch failed: {error_string(rc).decode()} ({rc})")


_PROTOTYPES = {
    "expert_chain_fwd": (ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 4
                         + [ctypes.c_int] * 4
                         + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]),
    "expert_chain_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def expert_mlp_chain(x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor,
                     skips: Sequence[int] = ()) -> torch.Tensor:
    """Fused L-layer per-expert MLP chain: x [E, C, M] -> [E, C, M].

    ws [L, E, M, M] and bs [L, E, 1, M] share x's dtype (bf16 under AMP).
    """
    global launches
    if x.device.type == "cpu":
        return expert_mlp_chain_plain(x, ws, bs, skips)
    check_rows(x, "x")
    check_chain_weights(ws, bs, x.dtype, x.device)
    e, c, m = x.shape
    if ws.shape[1] != e or ws.shape[-1] != m:
        raise ValueError(f"x {tuple(x.shape)} does not match ws "
                         f"{tuple(ws.shape)}")
    layers = ws.shape[0]
    out = torch.empty_like(x)
    lib = _build.load("expert_chain", _PROTOTYPES)
    rc = lib.expert_chain_fwd(
        x.device.index, x.data_ptr(), ws.data_ptr(), bs.data_ptr(),
        out.data_ptr(), e, c, m, layers, skip_mask(skips, layers),
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(rc, lib.expert_chain_error_string)
    launches += 1
    return out
