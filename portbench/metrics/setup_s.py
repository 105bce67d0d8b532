"""Seconds from the start of the process to the end of the warm-up: the
program's imports, scene and chunk loading (writing them on a checkout's
first run), kernel builds (first run), models, weights, and the warm-up
steps or requests."""


def read(run, cell):
    return run["setup_s"]
