"""The card's peak allocated memory over the training window, in GiB
(``max_memory_allocated`` after a reset at the window's start)."""


def read(run, cell):
    if run["kind"] != "train" or not run["peak"]:
        return None
    return run["peak"] / 2 ** 30
