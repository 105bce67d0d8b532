"""The expert chain's share of its roofline in the profiled training
steps: the least time of every chain launch a step makes (harness/flops:
each MoE call's padded shapes, the forward twice under remat, the
backward's dx and dW; the larger of operations over the peak and bytes
over the bandwidth) over the device time of the kernels below. A kernel
that a later change adds to the chain is a new entry of KERNELS."""
from harness import flops

# kernel-name substrings of the expert chain (K1, K2, K3, K4 and their
# 3xTF32 forms, the weight split and the partial-sum reduction)
KERNELS = ("chain_fwd_sm90", "chain_bwd_sm90", "chain_dw_sm90",
           "chain_fwd_tf32", "chain_bwd_tf32", "chain_dw_tf32",
           "tf32_split_weights", "reduce_partials")


def read(run, cell):
    tr = run.get("trace")
    if run["kind"] != "train" or tr is None or not tr.units:
        return None
    device_s = tr.device_s_matching(KERNELS)
    if device_s <= 0:
        return None
    cfg = cell["config"]
    # a rank's share of the global batch (the trace is rank 0's)
    rays = cell["traffic"]["batch"] // cell["workload"]["chips"]
    counts = flops.chain_counts(cfg, rays, True, cfg["remat"])
    if cfg["amp"]:
        bound = flops.bound_s(counts, "bf16")
    else:       # 3xTF32: three TF32 products a product
        bound = flops.bound_s([dict(c, flops=3 * c["flops"])
                               for c in counts], "tf32")
    return 100.0 * bound * tr.units / device_s
