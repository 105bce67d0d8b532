"""Rays rendered a second: the rays of every request completed in the
window over the window's time on the host's clock, results on the host."""


def read(run, cell):
    return run["rays_per_s"] if run["kind"] == "render" else None
