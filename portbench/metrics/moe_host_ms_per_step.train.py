"""Milliseconds of host time a training step spends in the MoE layers:
the self time of the program's ``moe.*`` spans (gate, routing,
dispatch, the expert chain's call and combine, in the forward and the
recompute, and the backwards of the chain, dispatch and combine).

Read from the profiled stretch (harness/spans.py); None where it holds
no program span."""
from harness.spans import self_ms


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "train":
        return None
    return self_ms(tr, "moe")
