"""The whole training step's share of the card's bf16 peak (989 TFLOP/s;
fp32 configurations against the TF32 peak): useful model operations a
ray (harness/flops.ray_flops: every product of the foreground and
background models, the routed expert only, forward times 3; no recompute,
no padded slot) times the window's rays a second, over the cards the
cell uses."""
from harness import flops


def read(run, cell):
    if run["kind"] != "train":
        return None
    cfg = cell["config"]
    peak = flops.PEAK_FLOPS["bf16" if cfg["amp"] else "tf32"]
    chips = cell["workload"]["chips"]
    return (100.0 * flops.ray_flops(cfg, True) * run["rays_per_s"]
            / (peak * chips))
