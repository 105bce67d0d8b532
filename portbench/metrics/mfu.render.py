"""A render request's share of the card's bf16 peak (989 TFLOP/s; fp32
configurations against the TF32 peak): useful model operations a ray
(forward, the routed expert only) times the window's rays a second."""
from harness import flops


def read(run, cell):
    if run["kind"] != "render":
        return None
    cfg = cell["config"]
    peak = flops.PEAK_FLOPS["bf16" if cfg["amp"] else "tf32"]
    return 100.0 * flops.ray_flops(cfg, False) * run["rays_per_s"] / peak
