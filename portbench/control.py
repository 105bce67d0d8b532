"""Readings for a cell's limits: the program's numbers and the control's
on several seeds in one process.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 \
        --seconds 5 [--out FILE]

For each seed, one run of the cell (set-up, a --seconds window, the
comparison) with the control beside it: the plain reference one precision
below the configuration's (fp8 for bf16) put in the program's place and
judged against the float32 reference by the same numbers. Prints one JSON
line a seed: {"seed", "program": {number: value}, "control": {...},
"rate", "setup_s"}; with --out also appends them there. The benchmark's
own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from harness import core  # noqa: E402


def numbers(checks: dict) -> dict:
    return {k: v["value"] for k, v in checks.items() if not k.startswith("_")}


def main(argv=None) -> int:
    import run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    core.env_defaults()
    cell = core.cell(args.workload)
    dev = core.cuda_device(cell["workload"]["chips"])
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(args.workload, seed, args.seconds, False, dev,
                           hooks={"control": True})
        c = out["checks"]
        row = {"workload": args.workload, "seed": seed,
               "program": numbers(c), "control": numbers(c["_control"]),
               "program_readings": c.get("_readings"),
               "control_readings": c["_control"].get("_readings"),
               "faults": {f: numbers(j)
                          for f, j in c.get("_faults", {}).items()},
               "rate": out["run"]["rays_per_s"],
               "setup_s": out["run"]["setup_s"]}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
