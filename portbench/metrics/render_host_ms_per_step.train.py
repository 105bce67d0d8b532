"""Milliseconds of host time a training step spends in the renderer's own
code: the self time of the program's ``render.*`` spans (the passes'
sampling, compositing and glue; the model calls inside them left out).

Read from the profiled stretch (harness/spans.py); None where it holds
no program span."""
from harness.spans import self_ms


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "train":
        return None
    return self_ms(tr, "render")
