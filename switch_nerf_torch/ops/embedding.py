"""The appearance embedding's lookup with a backward in a fixed order.

The forward is a row gather (``F.embedding``). The backward sums each table
row's gradient rows in ascending row order in fp32, so every run gives the
same bits and a resumed training run on the card repeats an uninterrupted
one (the JAX package's one-hot matmul gradient is as repeatable; no TPU
kernel stands behind it). On a CUDA tensor the sum is the hand-written code
of ``csrc/embedding_bwd.cu``: two launches and no library kernel, a
grouping pass that knows the key range [0, num) and a sum pass that streams
each index's rows in ascending order. On a CPU tensor it is the plain
version, a CPU ``index_add_``, which adds the rows one after another in
ascending order. The kernel sums in the same order and gives the plain
version's bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from switch_nerf_torch.ops import _build
from switch_nerf_torch.ops.expert_kernel import raise_on_error

__all__ = ["embedding", "embedding_bwd", "embedding_bwd_plain",
           "EmbeddingFn"]

# kernel launches since the caller last set them to 0 (read by chip_smoke.py)
launches = 0

_PROTOTYPES = {
    "embedding_bwd": (ctypes.c_int, [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_longlong]
                      + [ctypes.c_void_p] * 3
                      + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]),
    "embedding_bwd_workspace_bytes": (ctypes.c_longlong,
                                      [ctypes.c_longlong, ctypes.c_int]),
    "embedding_bwd_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def embedding_bwd_plain(idx: torch.Tensor, g: torch.Tensor,
                        num: int) -> torch.Tensor:
    """dW [num, F] fp32: g's rows [S, F] summed into their table rows in
    ascending row order, on the CPU (index_add_ adds row by row), returned
    on g's device."""
    out = torch.zeros((num, g.shape[-1]), dtype=torch.float32)
    out.index_add_(0, idx.reshape(-1).cpu(),
                   g.reshape(-1, g.shape[-1]).float().cpu())
    return out.to(g.device)


@functools.lru_cache(maxsize=64)
def _workspace_bytes(lib, rows: int, num: int) -> int:
    return lib.embedding_bwd_workspace_bytes(rows, num)


def embedding_bwd(idx: torch.Tensor, g: torch.Tensor,
                  num: int) -> torch.Tensor:
    """The kernel (or, for a CPU tensor, the plain version): dW [num, F]
    fp32 of the lookup at indices idx (any shape) for the gradient g
    [..., F]. The kernel reads fp32 rows at any row stride (a slice of a
    concatenation's gradient as it comes) and int64 indices; g of another
    type or layout, and other index types, are converted first."""
    global launches
    dev = g.device
    if dev.type == "cpu":
        return embedding_bwd_plain(idx, g, num)
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(f"g on {dev}, indices on {idx.device}")
    # the main path's g [S, F] and idx [S] pass as they are: the call's
    # host work shows in a chunk's time (PERF.md §6)
    feats = g.shape[-1]
    g2 = g if g.dim() == 2 else g.reshape(-1, feats)
    if g2.dtype != torch.float32 or g2.stride(-1) != 1:
        g2 = g2.float().contiguous()
    flat = idx if idx.dim() == 1 else idx.reshape(-1)
    if flat.dtype != torch.int64 or not flat.is_contiguous():
        flat = flat.long().contiguous()
    if flat.numel() != g2.shape[0]:
        raise ValueError(f"{flat.numel()} indices for {g2.shape[0]} "
                         "gradient rows")
    if not 0 < feats <= 8192:
        raise ValueError(f"the kernel takes 1..8192 features, got {feats}")
    dw = torch.empty((num, feats), dtype=torch.float32, device=dev)
    if num == 0:
        return dw
    lib = _build.load("embedding_bwd", _PROTOTYPES)
    rows = g2.shape[0]
    ws = torch.empty(_workspace_bytes(lib, rows, num), dtype=torch.uint8,
                     device=dev)
    rc = lib.embedding_bwd(
        dev.index, g2.data_ptr(), g2.stride(0), flat.data_ptr(),
        dw.data_ptr(), ws.data_ptr(), rows, num, feats,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, lib.embedding_bwd_error_string)
    launches += 1
    return dw


class EmbeddingFn(torch.autograd.Function):
    """Row gather forward; the fixed-order sum backward."""

    @staticmethod
    def forward(ctx, idx, weight):
        ctx.save_for_backward(idx)
        ctx.num = weight.shape[0]
        ctx.weight_dtype = weight.dtype
        return F.embedding(idx, weight)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return None, embedding_bwd(idx, g, ctx.num).to(ctx.weight_dtype)


def embedding(idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """weight[idx], differentiable in weight through ``EmbeddingFn``."""
    if torch.is_grad_enabled() and weight.requires_grad:
        return EmbeddingFn.apply(idx, weight)
    return F.embedding(idx, weight)
