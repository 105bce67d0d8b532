"""Share of a render request's model calls replayed from a CUDA graph:
the program's ``model.call`` spans that hold a ``model.graph`` span, over
all of its ``model.call`` spans, in %.

Read from the profiled stretch (harness/spans.py); None where it holds
no ``model.graph`` span (a program without the graphs)."""
from harness.spans import parents, program_spans


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "render" or tr is None or not tr.units:
        return None
    sp = program_spans(tr)
    up = parents(sp)
    calls = [i for i, (_, _, n) in enumerate(sp) if n == "model.call"]
    graphed = set()
    for i, (_, _, n) in enumerate(sp):
        if n != "model.graph":
            continue
        j = up[i]
        while j is not None and sp[j][2] != "model.call":
            j = up[j]
        if j is not None:
            graphed.add(j)
    if not calls or not any(n == "model.graph" for _, _, n in sp):
        return None
    return 100.0 * len(graphed) / len(calls)
