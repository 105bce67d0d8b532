"""Milliseconds a request spent outside the eval step: building the rays,
padding and copying them in, and copying the results to the host
(``Runner._batched_collective_fn``), by the harness's clock around the
request less its clock around the eval step (which ends in a
synchronize), averaged over the window's requests."""


def read(run, cell):
    return run.get("host_io_ms_per_unit") if run["kind"] == "render" else None
