"""The expert chain's share of its roofline in the profiled requests: the
least time of every chain launch a request makes (harness/flops: no-drop
calls at their routed rows, padded ones at capacity) over the device
time of the kernels below (K1R on the serving path, K1 / K3 when the
configuration serves padded)."""
from harness import flops

KERNELS = ("chain_fwd_sm90", "chain_fwd_tf32", "tf32_split_weights")


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "render" or tr is None or not tr.units:
        return None
    device_s = tr.device_s_matching(KERNELS)
    if device_s <= 0:
        return None
    cfg = cell["config"]
    counts = flops.chain_counts(cfg, cell["traffic"]["request_rays"], False,
                                False)
    if cfg["amp"]:
        bound = flops.bound_s(counts, "bf16")
    else:
        bound = flops.bound_s([dict(c, flops=3 * c["flops"])
                               for c in counts], "tf32")
    return 100.0 * bound * tr.units / device_s
