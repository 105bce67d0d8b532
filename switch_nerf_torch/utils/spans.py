"""The program's spans at its layer boundaries, on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function("snerf.<name>")``
while a profiler records, so the spans land in the same trace as the
device's kernels (``Runner``'s ``--profile_trace_step`` Chrome trace, or
any ``torch.profiler.profile`` around the program) and share its clock;
with no profiler it is one shared null context, which costs a check of
the profiler's state. The program keeps no timeline of its own.

The spans (``name``: what it covers):

  train.step             a training step (args: the state's step)
  train.forward          the render and the losses
  train.backward         ``torch.autograd.grad``
  train.allreduce        the ranks' average (more than one process)
  train.finite           the finite vote, the host's wait on the device
  train.adam             the update and its schedule
  eval.step              an eval step
  render.rays            a render call (classic and mip)
  render.bg, .coarse,    the classic renderer's background pass, its
  render.fine            coarse and its fine section
  model.call             one model chunk call (its recompute too)
  model.graph            a model call replayed from a CUDA graph
  model.graph_capture    a model call's capture (``graphs.py``)
  model.embedding_bwd    the appearance embedding's backward
  moe.gate               gate logits, noise, softmax; the external gate
  moe.route              the routing plan and the auxiliary loss
  moe.dispatch           the dispatch plan and the dispatch
  moe.experts            the expert chain and the residual expert
  moe.combine            the combine
  moe.experts_bwd,       the backwards of the chain, the dispatch and the
  moe.dispatch_bwd,      combine
  moe.combine_bwd
  remat.recompute        a model call's rerun in the backward
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch

__all__ = ["span", "spanned"]

_NULL = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str, args: Optional[str] = None):
    """A context over the code it wraps: ``snerf.<name>`` in the
    profiler's trace while one records, else the shared null context."""
    if _recording():
        return torch.profiler.record_function(f"snerf.{name}", args)
    return _NULL


def spanned(name: str) -> Callable[[Callable], Callable]:
    """A decorator: each call of the function in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
