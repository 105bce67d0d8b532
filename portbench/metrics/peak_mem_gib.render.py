"""The card's peak allocated memory over the rendering window, in GiB
(``max_memory_allocated`` after a reset at the window's start)."""


def read(run, cell):
    if run["kind"] != "render" or not run["peak"]:
        return None
    return run["peak"] / 2 ** 30
