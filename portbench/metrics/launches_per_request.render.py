"""Device kernels a render request launches, counted in the profiled
stretch (copies and fills left out), over its requests."""


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "render" or tr is None or not tr.units:
        return None
    return len(tr.kernels()) / tr.units
