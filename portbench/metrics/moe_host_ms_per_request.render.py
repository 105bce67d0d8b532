"""Milliseconds of host time a render request spends in the MoE layers:
the self time of the program's ``moe.*`` spans (gate, routing, the
no-drop dispatch, the ragged chain's call and combine).

Read from the profiled stretch (harness/spans.py); None where it holds
no program span."""
from harness.spans import self_ms


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "render":
        return None
    return self_ms(tr, "moe")
