"""Share of the profiled requests in which no device operation ran:
100 (1 - union of the operations' intervals / the stretch)."""


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "render" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
