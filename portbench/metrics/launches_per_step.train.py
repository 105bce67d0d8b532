"""Device kernels a training step launches, counted in the profiled
stretch (copies and fills left out), over its steps."""


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "train" or tr is None or not tr.units:
        return None
    return len(tr.kernels()) / tr.units
