"""Milliseconds a training step spends rerunning model calls in the
backward (--remat): the program's ``remat.recompute`` spans, whole.

Read from the profiled stretch (harness/spans.py); None where it holds
no program span."""
from harness.spans import whole_ms


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "train":
        return None
    return whole_ms(tr, "remat.recompute")
