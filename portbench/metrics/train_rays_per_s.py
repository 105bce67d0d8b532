"""Rays trained a second: every step of the window times the traffic's
batch (with several cards, the global batch), over the window's time on
the host's clock. The window ends after a whole step."""


def read(run, cell):
    return run["rays_per_s"] if run["kind"] == "train" else None
