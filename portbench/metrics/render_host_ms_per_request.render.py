"""Milliseconds of host time a render request spends in the renderer's own
code: the self time of the program's ``render.*`` spans (the passes'
sampling, compositing and glue; the model calls inside them left out).

Read from the profiled stretch (harness/spans.py); None where it holds
no program span."""
from harness.spans import self_ms


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "render":
        return None
    return self_ms(tr, "render")
