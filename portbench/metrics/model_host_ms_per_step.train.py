"""Milliseconds of host time a training step spends in the models' own
code: the self time of the program's ``model.*`` spans (a model chunk
call's encodings, dense trunk and heads, the whole background model,
forward and recompute; the appearance embedding's backward), the MoE
layers inside the calls left out.

Read from the profiled stretch (harness/spans.py); None where it holds
no program span."""
from harness.spans import self_ms


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "train":
        return None
    return self_ms(tr, "model")
