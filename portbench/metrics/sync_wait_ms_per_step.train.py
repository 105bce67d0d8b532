"""Milliseconds a training step's host waits on the device: the program's
``train.finite`` span, whole (the finite vote reads the step's metrics
back to the host, so it waits for the queued work).

Read from the profiled stretch (harness/spans.py); None where it holds
no program span."""
from harness.spans import whole_ms


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "train":
        return None
    return whole_ms(tr, "train.finite")
