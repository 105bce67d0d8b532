"""Tiny cells of the benchmark's configurations for CPU tests: the
published graphs at width 16, 4 experts of 3 layers, 8 + 8 samples,
256-point chunks, 64-ray batches and 32x24 scenes. The harness and the
reference read these numbers as they read the real ones."""
from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

W = 16


def _flag(flags, name, value):
    flags = list(flags)
    if name in flags:
        flags[flags.index(name) + 1] = value
    else:
        flags += [name, value]
    return flags


def config(name: str, amp: bool = False) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    flags = cfg["flags"]
    for k, v in (("--coarse_samples", "8"), ("--fine_samples", "8"),
                 ("--model_chunk_size", "256"), ("--moe_expert_num", "4"),
                 ("--bg_layer_dim", str(W))):
        flags = _flag(flags, k, v)
    if not amp:
        flags = flags + ["--no_amp"]
    cfg["flags"] = flags
    cfg["amp"] = amp
    cfg["model"].update(width=W, experts=4, expert_layers=3, skips=[1],
                        color_width=8)
    dir_in = W + 27 + 48
    cfg["graph_override"] = {
        "xyz": {"out_ch": W}, "0": {"in_ch": W, "h_ch": W, "out_ch": W,
                                   "num": 3, "skips": [1]},
        "1": {"in_ch": W, "out_ch": W}, "2": {"in_ch": dir_in, "out_ch": 8},
        "sigma": {"in_ch": W}, "color": {"in_ch": 8},
        "moe_external_gate": {"in_ch": W, "h_ch": W, "out_ch": W},
        "gate_input_norm": {"in_ch": W}}
    if "bg_model" in cfg:
        cfg["bg_model"]["width"] = W
    cfg["render"].update(coarse=8, fine=8, chunk=256, bg_chunk=256)
    return cfg


def cell(kind: str, amp: bool = False, limits=None) -> dict:
    """A tiny cell of the Building configuration: "train" or "render"."""
    cfg = config("building", amp)
    if kind == "render":
        traffic = json.loads((HERE / "traffic" / "mega_render_65536.json")
                             .read_text())
        traffic.update(request_rays=512, sample_rays=64, val_scale_factor=1)
        traffic["scene"].update(width=32, height=24, focal=28.0)
        lim = {"rgb_gap": 1.0, "rgb_mean_gap": 1.0, "rgb_share_wrong": 1.0}
    else:
        traffic = json.loads((HERE / "traffic" / "mega_train_8192.json")
                             .read_text())
        traffic.update(batch=64, num_chunks=2)
        traffic["scene"].update(width=32, height=24, focal=28.0)
        lim = {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap_median": 1.0,
               "wrong_rows": 0}
    return {"workload": {"name": f"tiny-{kind}", "config": "building",
                         "chips": 1},
            "config": cfg, "traffic": traffic,
            "limits": dict(lim, **(limits or {})),
            "end_to_end": [], "per_layer": []}
