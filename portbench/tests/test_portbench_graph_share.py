"""The reader of ``graph_share.render`` on synthetic traces: the share of
a request's ``model.call`` spans that hold a ``model.graph`` span.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import importlib.util

import pytest

import tiny
from harness.trace import Trace

MS = 1e-3


def _read(host, kind="render", units=1):
    spec = importlib.util.spec_from_file_location(
        "m_graph_share_render", tiny.HERE / "metrics" / "graph_share.render.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tr = Trace(device_ops=[], spans=[(0.0, 0.2, "request")],
               host_ops=[(s * MS, e * MS, n) for s, e, n in host],
               window=(0.0, 0.2), units=units)
    return mod.read({"kind": kind, "trace": tr}, {})


# a request's render passes: the background's two calls replayed, the
# foreground's first eager (its MoE spans inside), the next two replayed,
# the last one (a tail) eager
REQUEST = [
    (0, 100, "snerf.eval.step"),
    (1, 99, "snerf.render.rays"),
    (2, 20, "snerf.render.bg"),
    (3, 8, "snerf.model.call"),
    (4, 7, "snerf.model.graph"),
    (9, 14, "snerf.model.call"),
    (10, 13, "snerf.model.graph"),
    (21, 98, "snerf.render.coarse"),
    (22, 40, "snerf.model.call"),
    (25, 30, "snerf.moe.experts"),
    (41, 50, "snerf.model.call"),
    (42, 49, "snerf.model.graph"),
    (51, 60, "snerf.model.call"),
    (52, 59, "snerf.model.graph"),
    (61, 80, "snerf.model.call"),
    (62, 70, "snerf.moe.route"),
    (71, 72, "cudaGraphLaunch"),
]


def test_share_of_calls_that_replay():
    assert _read(REQUEST) == pytest.approx(100.0 * 4 / 6)


def test_every_call_replayed_reads_100():
    host = [op for op in REQUEST
            if op[:2] not in ((22, 40), (25, 30), (61, 80), (62, 70))]
    assert _read(host) == pytest.approx(100.0)


def test_a_capture_counts_by_its_replay():
    """The capture call replays inside its model.graph_capture's call."""
    host = [(0, 10, "snerf.model.call"), (1, 6, "snerf.model.graph_capture"),
            (7, 9, "snerf.model.graph"), (11, 20, "snerf.model.call")]
    assert _read(host) == pytest.approx(50.0)


def test_no_graph_span_reads_none():
    """A program without the graphs (model.call spans only), a training
    run, or no trace at all: nothing to read."""
    eager = [op for op in REQUEST if op[2] != "snerf.model.graph"]
    assert _read(eager) is None
    assert _read(REQUEST, kind="train") is None
    assert _read(REQUEST, units=0) is None
    assert _read([]) is None
