"""What every cell shares: finding the cell's files by name, the guards,
the device's description, seeds, the configuration's hyperparameters for
the program under test, weights, and the result line.

The program under test is ``switch_nerf_torch``; the yardstick (traffic,
reference, arithmetic, limits) lives in this folder and imports nothing of
it but the system's entry points.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent.parent          # portbench/
ROOT = HERE.parent                                     # the checkout
CACHE = HERE / ".cache"                                # scenes, chunks, runs

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "switch_nerf_tpu")


class CellError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


def forbidden_modules(names) -> List[str]:
    """The module names whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise CellError(f"{path} is missing")
    return json.loads(path.read_text())


def cell(name: str) -> dict:
    """The workload `name` with its configuration, traffic mix, limits
    and metrics, each from its own file."""
    b = benchmark()
    work = {w["name"]: w for w in b["workloads"]}
    if name not in work:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in b["configs"]}[w["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])
    return {"workload": w, "config": cfg, "traffic": traffic,
            "limits": limits,
            "end_to_end": [m for m in b["end_to_end"] if mine(m)],
            "per_layer": [m for m in b["per_layer"] if mine(m)]}


def seeds(seed: int) -> Dict[str, int]:
    """Sub-seeds of --seed (any whole number): weights, the step's
    generator, the sample of answers compared, the batch order."""
    s = np.random.SeedSequence(abs(int(seed))).generate_state(4, np.uint64)
    return {"weights": int(s[0] % 2 ** 62), "generator": int(s[1] % 2 ** 62),
            "sample": int(s[2] % 2 ** 62), "data": int(s[3] % 2 ** 62)}


def cuda_device(chips: int):
    """The card, or CellError: no CUDA, or fewer cards than the cell
    asks for. Never the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise CellError("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise CellError(f"{torch.cuda.device_count()} CUDA devices, the "
                        f"cell needs {chips}")
    return torch.device("cuda", 0)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def device_entry(dev, count: int, peak: int) -> dict:
    import torch
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count, "memory_peak_bytes": int(peak),
                "power_limit": power_limit()}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak)}


# ---------------------------------------------------- the program's side ---

def port_hparams(cfg: dict, extra: List[str]):
    """The program's hyperparameters: the configuration's flags (its YAML
    under configs/ and the published command's flags) plus `extra`."""
    from switch_nerf_torch.config import get_opts, parse_args
    flags = list(cfg["flags"])
    i = flags.index("--config_file")
    flags[i + 1] = str(ROOT / flags[i + 1])
    h = parse_args(get_opts(), flags + extra)
    for tag, over in cfg.get("graph_override", {}).items():
        h.model["layers"][tag].update(over)      # the tests' tiny widths
    check_hparams(h, cfg)
    return h


def check_hparams(h, cfg: dict) -> None:
    """The program's parsed numbers must be the ones the reference is
    given: a drift of either side stops the run."""
    m, r, t = cfg["model"], cfg["render"], cfg["train"]
    layer0 = h.model["layers"]["0"]
    pairs = {
        "width": (layer0["out_ch"], m["width"]),
        "experts": (h.moe_expert_num, m["experts"]),
        "expert_layers": (layer0["num"], m["expert_layers"]),
        "skips": (list(layer0.get("skips") or []), m["skips"]),
        "capacity_factor": (h.moe_capacity_factor, m["capacity_factor"]),
        "prioritized": (bool(h.batch_prioritized_routing), m["prioritized"]),
        "appearance_dim": (h.appearance_dim, m["appearance_dim"]),
        "mip": (bool(h.use_mip), m["mip"]),
        "coarse": (h.coarse_samples, r["coarse"]),
        "fine": (h.fine_samples, r["fine"]),
        "chunk": (h.model_chunk_size, r["chunk"]),
        "sigma_noise": (bool(h.use_sigma_noise), r["sigma_noise"]),
        "eval_drop": (bool(h.moe_test_batch), r["eval_drop"]),
        "train_drop": (bool(h.moe_train_batch), True),
        "lr": (h.lr, t["lr"]),
        "l_aux_weight": (h.moe_l_aux_wt, t["l_aux_weight"]),
        "amp": (bool(h.amp), cfg["amp"]),
    }
    bad = {k: v for k, v in pairs.items() if v[0] != v[1]}
    if bad:
        raise CellError(f"program flags differ from the configuration "
                        f"file: {bad}")


def load_weights(model, weights: Dict[str, "object"]) -> None:
    """Copy the benchmark's weights into the program's model, by name;
    the two must name the same leaves with the same shapes."""
    import torch
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise CellError(
            f"leaves differ: program only {sorted(set(params) - set(weights))}"
            f", reference only {sorted(set(weights) - set(params))}")
    with torch.no_grad():
        for k, p in params.items():
            if tuple(p.shape) != tuple(weights[k].shape):
                raise CellError(f"{k}: {tuple(p.shape)} against "
                                f"{tuple(weights[k].shape)}")
            p.copy_(weights[k])


def gap(program: float, reference: float, floor: float = 0.0) -> float:
    """|program - reference| / max(|reference|, floor)."""
    return abs(program - reference) / max(abs(reference), floor, 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """Each kept leaf's gap of norms, against the larger of its own
    reference norm and the median leaf's."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: gap(prog[k], ref[k], med) for k in keep}


class Marks:
    """Named stretches of set-up on the host's clock, each ended by a
    call (after the device's queue has drained), for the run's stderr."""

    def __init__(self, dev=None):
        self.dev, self.t = dev, time.perf_counter()
        self.phases: Dict[str, float] = {}

    def __call__(self, name: str) -> None:
        if self.dev is not None and self.dev.type == "cuda":
            import torch
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now


def host_reading() -> Dict[str, object]:
    """The process's CPU seconds and bytes written so far, and the host's
    load, beside set-up's wall time: set-up that waits on a busy host or
    on the disk shows as wall time with no CPU time of its own."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out: Dict[str, object] = {"cpu_s": ru.ru_utime + ru.ru_stime,
                              "load": list(os.getloadavg()),
                              "cpus": len(os.sched_getaffinity(0))}
    for name, path in (("io", "/proc/self/io"),
                       ("psi_cpu", "/proc/pressure/cpu"),
                       ("psi_io", "/proc/pressure/io")):
        try:
            out[name] = Path(path).read_text().split("\n")[:2]
        except OSError:
            pass
    return out


class Clock:
    """Seconds since construction, by the host's monotonic clock."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict,
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def env_defaults() -> None:
    """Caches inside the checkout at fixed paths; no JAX through
    libraries that would load it."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
