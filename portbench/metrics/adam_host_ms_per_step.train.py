"""Milliseconds a training step spends in the update: the program's
``train.adam`` span (Adam and the learning-rate schedule), whole.

Read from the profiled stretch (harness/spans.py); None where it holds
no program span."""
from harness.spans import whole_ms


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "train":
        return None
    return whole_ms(tr, "train.adam")
