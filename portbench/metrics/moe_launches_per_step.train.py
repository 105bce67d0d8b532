"""Kernel launches a training step makes inside the program's ``moe.*``
spans: each launch call of the host goes to the innermost program span
holding its start.

Read from the profiled stretch (harness/spans.py); None where it holds
no program span."""
from harness.spans import launches


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "train":
        return None
    return launches(tr, "moe")
