"""Milliseconds a step spent in the data layer: the harness's clock
around each batch fetch from the program's chunked dataset and its copy
to the card (``Runner._put_batch``), averaged over the window's steps."""


def read(run, cell):
    return run.get("data_ms_per_unit") if run["kind"] == "train" else None
