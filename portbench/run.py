"""Run one cell of the benchmark of switch_nerf_torch once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json. Loads the cell's
configuration, traffic mix and limits by name, sets the program up (its
kernels build into switch_nerf_torch/_build/ on the first run of a
checkout; scenes and chunks are written once under portbench/.cache/),
warms up, measures whole steps or requests for --seconds, compares what
the timed path produced with the plain reference, and prints one JSON
line: with --trace 0 the cell's end-to-end metrics, with --trace 1 its
per-layer ones, read from a short profiled stretch after the window by the
readers in portbench/metrics/. The numbers compared, each beside its
limit, are the last lines on standard error and the line's last key.

Exits non-zero with no result when there is no CUDA device (or fewer than
the cell asks for), when BENCHMARK.json or a file of the cell is missing,
or when a module of JAX or of the JAX package is loaded once the window
has closed.
"""
from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    # the bytecode of all that a run imports (torch, and the compiler stack
    # that its optimizer pulls in: some 2,000 modules) is cached at a fixed
    # path inside the checkout, also where the environment asks Python to
    # write none, so that only the first run of a checkout compiles it
    sys.pycache_prefix = str(HERE / ".cache" / "pyc")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import traceback  # noqa: E402

if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from harness import core  # noqa: E402


def read_metrics(cell: dict, run: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (--trace 0) or per-layer ones, each
    from its reader; a reader that finds nothing leaves its metric out."""
    out = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{m['name'].replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(run, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name, seed: int, seconds: float, trace: bool, dev,
             chips: int = 1, hooks=None, clock=None) -> dict:
    """Set up, measure and compare one run of cell `name` (or a cell
    dict) on `dev`. Returns {"line": the result line, "checks": ...,
    "run": ...}."""
    clock = clock or core.Clock()
    cell = core.cell(name) if isinstance(name, str) else name
    kind = cell["traffic"]["kind"]
    if kind == "train":
        from harness import train as mod
    elif kind == "render":
        from harness import render as mod
    else:
        raise core.CellError(f"traffic kind {kind!r}")
    run = mod.run(cell, seed, seconds, trace, dev, clock, hooks)
    checks = run["checks"]
    numbers = {k: v for k, v in checks.items() if not k.startswith("_")}
    correct = all(core.finite(v["value"]) and v["value"] <= v["limit"]
                  for v in numbers.values())
    correct = correct and checks["_readings"].get("finite", True)
    loaded = core.forbidden_modules(list(sys.modules))
    if loaded:
        raise core.CellError(f"forbidden modules loaded: {loaded}")
    device = core.device_entry(dev, chips, run["peak"])
    breakdown = None
    if trace and run["trace"] is not None:
        tr = run["trace"]
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        breakdown = tr.breakdown()
    metrics = read_metrics(cell, run, trace)
    line = core.result_line(correct, run["attempted"], run["failed"],
                            metrics, device,
                            {k: {"value": v["value"], "limit": v["limit"]}
                             for k, v in numbers.items()}, breakdown)
    return {"line": line, "checks": checks, "run": run, "correct": correct}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    clock = core.Clock()
    core.env_defaults()
    try:
        cell = core.cell(args.workload)
        dev = core.cuda_device(cell["workload"]["chips"])
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                       cell["workload"]["chips"], clock=clock)
    except core.CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except Exception:                     # the run gives no result
        traceback.print_exc()
        return 1
    checks = out["checks"]
    print(json.dumps({"setup_phases_s": out["run"].get("setup_phases")}),
          file=sys.stderr)
    print(json.dumps(checks.get("_readings", {})), file=sys.stderr)
    for k, v in checks.items():
        if not k.startswith("_"):
            print(f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})",
                  file=sys.stderr)
    print(out["line"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
