"""Rematerialisation of the renderer's model chunks (--remat, on by default).

Port of the ``jax.checkpoint`` that ``switch_nerf_tpu/render/rendering.py``
(:139-159) puts around each model chunk, with its policy
``save_only_these_names``. In a training pass each model call of
``render/rendering.run_model_chunked`` runs under ``checkpoint``: autograd
keeps none of the call's activations, and the backward runs the call again
to rebuild them, one chunk at a time. Across that boundary a chunk keeps
its inputs (its points and sigma noise, which the renderer draws outside
the call, as JAX keeps ``sigma_noise`` by name) and the values that
``keep`` records under a name of the save set (``save_names``):

  moe_plan        each MoE layer's integer routing plan: its experts,
                  locations, counts and, for a chunk that spans ranks, the
                  chunk-wide experts (``ops/routing.extract_critical``), and
                  the padded dispatch plan's slot, kept, slot_to_token and
                  filled (``ops/dispatch.build_dispatch_plan``)
  moe_dispatched  the [E, C, M] dispatch buffer (``ops/dispatch``)
  pe_out          the positional encodings (``ops/encoding``); by default
                  only off the mip renderer, whose encodings cost more
                  memory than their recompute
  gate_feat       the external gate's features (``models/nerf_moe``);
                  only with SWITCH_NERF_REMAT_SAVE=+gate_feat

and, whatever the set, what the recompute must not draw or exchange anew:
the chunk's random draws (gate noise, dropout masks: the port's generator
is stateful, so the draws are kept as JAX keeps sigma_noise), the result
of the load-importance loss's sum over the holders of a shared chunk
(``parallel/chunks``) and the expert exchange's header
(``parallel/experts``). The recompute therefore runs no routing sort,
cumsum or routing collective. Under expert parallelism it exchanges the
dispatch buffer with the experts' owners again (every rank recomputes the
same chunks in the same order, so the exchanges pair up).

JAX's plan also saves the gates; the port recomputes them (a softmax of
the chunk's logits and a gather at the kept experts), because they carry
the gradient to the gate and the trunk. ``checkpoint`` is the
non-reentrant ``torch.utils.checkpoint`` (the train step takes its
gradients with ``torch.autograd.grad``), which matches the recomputed
saved tensors to the forward's by order and checks their shapes and
dtypes: the recompute runs the same autograd ops in the same order, and a
kept value is replayed in place of the code that makes it only where that
code records no autograd op (integer routing, the forward of an
``autograd.Function``, a value with no gradient). A kept value that
carries a gradient (gate_feat) is made again and its kept copy taken
in its place.

SWITCH_NERF_REMAT_SAVE (read at each call, as JAX reads it) adds names
(``+name`` or ``name``) or takes them away (``-name``), comma-separated,
for A/B runs; no choice changes a number. ``-sigma_noise`` changes
nothing here: the noise is an input of the call. JAX's
``SWITCH_NERF_SCAN_UNROLL`` and ``SWITCH_NERF_SCAN_SPLIT_TRANSPOSE`` tune
``lax.scan``, which is a Python loop here; they have no counterpart.
"""
from __future__ import annotations

import contextvars
import dataclasses
import os
from typing import Any, Callable, FrozenSet, Iterator, List, Optional

import torch
import torch.utils.checkpoint

__all__ = ["save_names", "keep", "recomputing", "checkpoint", "STATS",
           "reset_stats"]

# model calls run under checkpoint, their recomputes, and the bytes kept
# across the boundary: the calls' tensor inputs and their kept values, by
# name (None: the draws and the collectives' results)
STATS = {"calls": 0, "recomputes": 0, "input_bytes": 0, "kept_bytes": {}}


def reset_stats() -> None:
    STATS.update(calls=0, recomputes=0, input_bytes=0, kept_bytes={})


def save_names(use_mip: bool = False,
               save_pe: Optional[bool] = None) -> FrozenSet[str]:
    """The names a chunk keeps: moe_plan, moe_dispatched, sigma_noise, and
    pe_out when ``save_pe`` (None: off the mip renderer), then
    SWITCH_NERF_REMAT_SAVE's changes."""
    names = {"moe_plan", "moe_dispatched", "sigma_noise"}
    if (not use_mip) if save_pe is None else save_pe:
        names.add("pe_out")
    for n in os.environ.get("SWITCH_NERF_REMAT_SAVE", "").split(","):
        n = n.strip()
        if n.startswith("-"):
            names.discard(n[1:])
        elif n:
            names.add(n.lstrip("+"))
    return frozenset(names)


@dataclasses.dataclass
class _Tape:
    """One model call's kept values, in the order its forward made them;
    `cursor` is None in the forward and walks them in a recompute."""
    names: FrozenSet[str]
    entries: List[tuple] = dataclasses.field(default_factory=list)
    cursor: Optional[int] = None
    recorded: bool = False


_TAPE: contextvars.ContextVar[Optional[_Tape]] = contextvars.ContextVar(
    "remat_tape", default=None)


def _tensors(value) -> Iterator[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


def _detached(value):
    """`value` (a tensor, or tuples and lists of them and of other
    values) with each tensor a new detached alias of its storage."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_detached(v) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_detached(v) for v in value)
    return value


class _Kept(torch.autograd.Function):
    """The kept copy's value, the gradient to the value made again."""

    @staticmethod
    def forward(ctx, made, kept):
        return kept.detach()

    @staticmethod
    def backward(ctx, g):
        return g, None


def recomputing() -> bool:
    """Whether the code runs in a model call's recompute (the backward's
    second run of a call under ``checkpoint``)."""
    tape = _TAPE.get()
    return tape is not None and tape.cursor is not None


def keep(fn: Callable[..., Any], *args, name: Optional[str] = None):
    """fn(*args) in a model call's forward; in its recompute, the value the
    forward made. With a `name`, only when the call's save set holds it;
    with none, always (draws, collectives' results). Outside a call under
    ``checkpoint``, fn(*args)."""
    tape = _TAPE.get()
    if tape is None or (name is not None and name not in tape.names):
        return fn(*args)
    if tape.cursor is None:
        value = fn(*args)
        grads = any(t.requires_grad for t in _tensors(value))
        tape.entries.append((name, _detached(value), grads))
        kept = STATS["kept_bytes"]
        kept[name] = kept.get(name, 0) + sum(
            t.numel() * t.element_size() for t in _tensors(value))
        return value
    made, value, grads = tape.entries[tape.cursor]
    tape.cursor += 1
    if made != name:
        raise RuntimeError(f"remat: the recompute asked for {name!r} where "
                           f"the forward kept {made!r}")
    if grads:
        # its maker records autograd ops whose saved tensors the recompute
        # must rebuild, so it runs again
        return _Kept.apply(fn(*args), value)
    return _detached(value)


def checkpoint(fn: Callable[..., Any], names: FrozenSet[str], *args):
    """fn(*args) with its activations rebuilt in the backward, keeping the
    inputs and what ``keep`` records under `names`. Tensors among `args`
    are the call's inputs; fn must make the same autograd ops each time it
    runs (``keep`` replays the rest)."""
    tape = _Tape(names)
    STATS["calls"] += 1
    STATS["input_bytes"] += sum(t.numel() * t.element_size()
                                for t in _tensors(args))

    def run(*a):
        if tape.recorded:
            tape.cursor = 0
            STATS["recomputes"] += 1
        token = _TAPE.set(tape)
        try:
            return fn(*a)
        finally:
            _TAPE.reset(token)
            tape.recorded = True

    # the draws come from the step's generator through keep, so the global
    # RNG states need no saving
    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)
