"""Milliseconds of host time a render request spends in the models' own
code: the self time of the program's ``model.*`` spans (a model chunk
call's encodings, dense trunk and heads, the whole background model),
the MoE layers inside the calls left out.

Read from the profiled stretch (harness/spans.py); None where it holds
no program span."""
from harness.spans import self_ms


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "render":
        return None
    return self_ms(tr, "model")
