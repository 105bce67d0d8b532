"""CUDA graphs for the eval step's whole-chunk model calls.

An eval request makes hundreds of model calls of one shape: the runner
pads every request to --image_pixel_batch_size rays, and the renderer
cuts the points into full chunks of its chunk size
(``render/rendering.run_model_chunked``). Each call launches about 130
kernels one at a time from Python, so the host, not the card, sets the
pace. ``GraphedModelFn`` wraps a model function of the renderer's
contract: a call that qualifies is captured once as a
``torch.cuda.CUDAGraph`` and replayed from then on; every other call runs
as it is. A replay runs the same kernels at the same shapes in the same
order as the eager call, so its outputs are the same bits.

A call qualifies when
  - its points are on a CUDA device, grad is off, ``train`` is false and
    there is no sigma noise: it draws nothing and builds no autograd
    graph;
  - it has the renderer's chunk size for the model (``rows``), so the
    exact-size call on the remainder runs eagerly;
  - the model reads nothing back to the host and talks to no other rank
    inside a call (``capturable``, read from the module tree once): it
    has no MoE experts under expert or weight parallelism (the token
    exchange and its gloo header; at eval the whole experts that
    ``models/experts.gathered`` holds outside the parameters) and no ffn
    experts whose hidden width differs from the model's (their ragged
    form reads the expert counts on the host).

The first qualifying call for a key runs eagerly (it builds and loads the
kernels and warms the libraries), the second is captured and replayed,
later ones replay. The key is the points' shape, dtype and device, the
opt-in fused dispatch (``models/moe`` reads it at each call) and the
storage of every parameter and buffer of the model: weights changed in
place (Adam, ``load_state_dict``, a checkpoint load) are what a replay
reads; weights moved to new storage (``.to()`` another dtype,
``load_state_dict(..., assign=True)``) lead to a new capture, and the old
graph is dropped. The points are copied into the
graph's input buffer, and the outputs are cloned out, since the renderer
keeps every chunk's output until it concatenates them.

The graphs of one eval step (``GraphPool``) share one memory pool, which
they hold for the eval step's life: about one chunk call's intermediates
(0.87 GiB more reserved for Building's 131,072-point chunks on the H100,
PERF.md §6), beside whatever else the process runs, as a training run's
validation renders do. The ops' Python launch counters
(``ops/expert_kernel.launches`` and the rest) count a replay's launches
as the captured call counted them.

A replay runs inside the span ``model.graph``, a capture inside
``model.graph_capture`` (``utils/spans``).
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from switch_nerf_torch.models.experts import ExpertMLP, FFNExperts
from switch_nerf_torch.ops import (embedding, expert_kernel, fused_dispatch,
                                   ragged_chain)
from switch_nerf_torch.utils.spans import span

__all__ = ["capturable", "GraphPool", "GraphedModelFn"]

# the ops' launch counters (chip_smoke.py reads them)
_COUNTERS = ((expert_kernel, "launches"), (expert_kernel, "bwd_launches"),
             (fused_dispatch, "launches"), (fused_dispatch, "bwd_launches"),
             (ragged_chain, "ragged_launches"),
             (ragged_chain, "ragged_bwd_launches"), (embedding, "launches"))


def _counts() -> List[int]:
    return [getattr(mod, name) for mod, name in _COUNTERS]


def capturable(model: nn.Module) -> bool:
    """Whether a call of `model` can be captured: no MoE experts under
    expert or weight parallelism, no ffn experts with a hidden width other
    than the model's."""
    for m in model.modules():
        if isinstance(m, ExpertMLP) and (m.ep is not None
                                         or m.wp is not None):
            return False
        if isinstance(m, FFNExperts) and m.w1.shape[-1] != m.w1.shape[-2]:
            return False
    return True


class GraphPool:
    """The memory pool that the graphs of one eval step share, made at
    the first capture."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class _Graph:
    """One captured model call: its input buffer, outputs and the ops'
    launch counts it adds."""

    def __init__(self, fn: Callable, pts: torch.Tensor, generator, key,
                 pool: GraphPool):
        self.key = key
        self.input = pts.clone()
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool.handle()):
            self.outputs = fn(self.input, None, False, generator)
        self.launches = [b - a for a, b in zip(before, _counts())]
        # the capture ran no kernel: each replay counts them
        for (mod, name), n in zip(_COUNTERS, before):
            setattr(mod, name, n)

    def replay(self, pts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        self.input.copy_(pts)
        self.graph.replay()
        for (mod, name), n in zip(_COUNTERS, self.launches):
            setattr(mod, name, getattr(mod, name) + n)
        return tuple(t.clone() for t in self.outputs)


class GraphedModelFn:
    """model_fn(points, sigma_noise, train, generator) of ``model`` (the
    renderer's contract, ``trainer.make_model_fn``), with a call that
    qualifies (module docstring) replayed from a CUDA graph; `rows` is
    the renderer's chunk size for this model."""

    def __init__(self, fn: Callable, model: nn.Module, rows: int,
                 pool: GraphPool):
        self.fn, self.rows, self.pool = fn, rows, pool
        self.capturable = capturable(model)
        # each module's own parameter and buffer dicts, read at every
        # qualifying call (a tenth of the cost of model.parameters()),
        # so a tensor set anew in a dict is seen
        self.tensors = [d for m in model.modules()
                        for d in (m._parameters, m._buffers)]
        self.warmed = None                  # the key of the eager call
        self.entry: Optional[_Graph] = None

    def qualifies(self, pts: torch.Tensor,
                  sigma_noise: Optional[torch.Tensor], train: bool) -> bool:
        return (self.capturable and pts.is_cuda and not train
                and sigma_noise is None and not torch.is_grad_enabled()
                and pts.shape[0] == self.rows)

    def key(self, pts: torch.Tensor) -> tuple:
        return (tuple(pts.shape), pts.dtype, pts.device,
                os.environ.get("SWITCH_NERF_FUSED_DISPATCH", "0"),
                tuple(t.data_ptr() for d in self.tensors
                      for t in d.values() if t is not None))

    def __call__(self, pts, sigma_noise=None, train=False, generator=None):
        if not self.qualifies(pts, sigma_noise, train):
            return self.fn(pts, sigma_noise, train, generator)
        key = self.key(pts)
        if self.entry is None or self.entry.key != key:
            if self.warmed != key:
                self.warmed = key
                return self.fn(pts, sigma_noise, train, generator)
            self.entry = None               # its pool blocks go back first
            with span("model.graph_capture"):
                self.entry = _Graph(self.fn, pts, generator, key, self.pool)
        with span("model.graph"):
            return self.entry.replay(pts)
