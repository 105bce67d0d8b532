"""What the program's own spans say in a profiled stretch.

The program (``switch_nerf_torch/utils/spans.py``) records its layer
boundaries as ``snerf.<layer>.<part>`` host ops while a profiler
records, on the profiler's clock; ``trace.profiled`` keeps them among a
``Trace``'s ``host_ops``. Here:

- a span's self time is its duration less the union of the program's
  spans nested inside it. Nesting is by time, not by thread: the backward's
  spans run on the autograd engine's thread while the main thread sits
  in ``train.backward``;
- a launch is a host op named as one of ``LAUNCHES``, and goes to the
  innermost program span (the latest started) that holds its start.

Every reading is per step or request (over ``tr.units``), and None where
the stretch holds no program span (a program without them).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from .trace import Interval, Trace, union_length

PREFIX = "snerf."
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


def program_spans(tr: Trace) -> List[Interval]:
    """The program's spans, (start, end, name without the prefix), in
    nesting order: by start, the longer first."""
    return sorted(((s, e, n[len(PREFIX):]) for s, e, n in tr.host_ops
                   if n.startswith(PREFIX)), key=lambda x: (x[0], -x[1]))


def parents(spans: List[Interval]) -> List[Optional[int]]:
    """The index of the span each span nests in (None: none), by time."""
    out: List[Optional[int]] = []
    stack: List[int] = []
    for i, (s, e, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] < e:
            stack.pop()
        out.append(stack[-1] if stack else None)
        stack.append(i)
    return out


def self_seconds(spans: List[Interval]) -> List[float]:
    """Each span's duration less the union of the spans nested in it."""
    kids: Dict[int, List[Tuple[float, float]]] = {}
    for i, p in enumerate(parents(spans)):
        if p is not None:
            kids.setdefault(p, []).append(spans[i][:2])
    return [(e - s) - union_length(kids.get(i, []))
            for i, (s, e, _) in enumerate(spans)]


def launch_owners(tr: Trace, spans: List[Interval]) -> List[Optional[int]]:
    """For each launch in the stretch, the index of the innermost span
    holding its start (None: outside every program span)."""
    starts = sorted(s for s, _, n in tr.host_ops if n in LAUNCHES)
    # a sweep over span starts, span ends and launches in time order; the
    # open spans by (start, -end), so the innermost is the last
    edges = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    key = [(s, -e, i) for i, (s, e, _) in enumerate(spans)]
    open_: List[Tuple[float, float, int]] = []
    out: List[Optional[int]] = []
    j = 0
    for t in starts:
        while j < len(edges) and edges[j][0] <= t:
            _, opening, i = edges[j]
            if opening:
                bisect.insort(open_, key[i])
            else:
                open_.remove(key[i])
            j += 1
        out.append(open_[-1][2] if open_ else None)
    return out


def _family(name: str, families) -> bool:
    return any(name == f or name.startswith(f + ".") for f in families)


def self_ms(tr: Optional[Trace], *families: str) -> Optional[float]:
    """Milliseconds a unit of self time in the spans of `families`
    (``"moe"``: every ``moe.*``)."""
    spans = program_spans(tr) if tr is not None and tr.units else []
    if not spans:
        return None
    own = self_seconds(spans)
    return 1e3 * sum(t for t, (_, _, n) in zip(own, spans)
                     if _family(n, families)) / tr.units


def whole_ms(tr: Optional[Trace], name: str) -> Optional[float]:
    """Milliseconds a unit in the spans named `name`, whole."""
    spans = program_spans(tr) if tr is not None and tr.units else []
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e, n in spans if n == name) / tr.units


def launches(tr: Optional[Trace], *families: str) -> Optional[float]:
    """Launches a unit that went to the spans of `families`."""
    spans = program_spans(tr) if tr is not None and tr.units else []
    if not spans:
        return None
    return sum(1 for i in launch_owners(tr, spans)
               if i is not None and _family(spans[i][2], families)
               ) / tr.units
