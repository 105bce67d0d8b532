"""A short profiled stretch of the timed path, and what the per-layer
readers take from it.

``profiled(fn)`` runs fn() under ``torch.profiler`` (CPU and CUDA) and
returns a ``Trace``: every device operation (kernels, copies, fills) as
(start, end, name) in seconds on the profiler's clock, the harness's own
spans (``span(name)``, recorded as ``harness.<name>``) and the host's
operations, from which it derives the device's busy time as the union of
the operations' intervals (operations that overlap count once), the idle
gaps between them labelled by what the host was doing, and the device
time by kernel.
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

Interval = Tuple[float, float, str]


@contextlib.contextmanager
def span(name: str):
    """A harness span, seen by the profiler when one records."""
    import torch
    with torch.profiler.record_function(f"harness.{name}"):
        yield


def union_length(intervals: List[Tuple[float, float]], lo: float = None,
                 hi: float = None) -> float:
    """The length of the union of [start, end) intervals, clipped to
    [lo, hi] when given."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def kernel_label(name: str) -> str:
    """A kernel's name without namespace, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("<")[0].split("(")[0][:80]


@dataclass
class Trace:
    device_ops: List[Interval]
    spans: List[Interval]
    host_ops: List[Interval]
    window: Tuple[float, float]
    units: int = 0                 # steps or requests inside the window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> List[Interval]:
        return [k for k in self.device_ops
                if not k[2].startswith(("Memcpy", "Memset"))]

    def busy_s(self) -> float:
        return union_length([(s, e) for s, e, _ in self.device_ops],
                            *self.window)

    def device_s_by_label(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e, n in self.device_ops:
            k = kernel_label(n)
            out[k] = out.get(k, 0.0) + (e - s)
        return out

    def device_s_matching(self, keys) -> float:
        low = [k.lower() for k in keys]
        return sum(e - s for s, e, n in self.device_ops
                   if any(k in n.lower() for k in low))

    def idle_by_host(self, top: int = 10) -> List[List]:
        """Idle device seconds inside the window, summed by what the host
        was doing when each gap began: the harness span and the innermost
        host operation running then."""
        idle = gaps([(s, e) for s, e, _ in self.device_ops], *self.window)
        host = sorted(self.host_ops)
        starts = [h[0] for h in host]
        spans = sorted(self.spans)
        out: Dict[str, float] = {}
        for s, e in idle:
            label = "outside harness spans"
            for a, b, n in spans:
                if a <= s < b:
                    label = n
            i = bisect.bisect_right(starts, s)
            inner = None
            for a, b, n in reversed(host[max(0, i - 4000):i]):
                if b > s:
                    inner = n
                    break
            if inner:
                label = f"{label}: {inner}"
            out[label] = out.get(label, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(out.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def breakdown(self) -> Dict:
        ops = sorted(self.device_s_by_label().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops[:10]],
                "idle_gaps": self.idle_by_host()}


def profiled(fn: Callable[[], int]) -> Trace:
    """Run fn() (which returns how many steps or requests it ran, inside
    harness spans) under the profiler. The window runs from the first
    harness span's start to the last one's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        units = fn()
        torch.cuda.synchronize()
    dev, spans, host = [], [], []
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            # a span's mirror on the device's timeline is no operation
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("harness.")):
                dev.append((s, t, e.name))
        elif e.name.startswith("harness."):
            spans.append((s, t, e.name[len("harness."):]))
        else:
            host.append((s, t, e.name))
    if not spans:
        raise RuntimeError("the profiled stretch recorded no harness span")
    window = (min(s for s, _, _ in spans), max(t for _, t, _ in spans))
    return Trace(dev, spans, host, window, units)
