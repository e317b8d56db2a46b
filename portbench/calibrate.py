#!/usr/bin/env python3
"""Readings for setting a cell's limits: many seeds of the program, of the
control (the plain reference at TF32 in the port's place) and of planted
faults, in one process.

    python portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --modes program,control,fault:half --seconds 3 --out FILE.jsonl

Each (mode, seed) run is a whole run of the cell at its own size (window
of ``--seconds``); one JSON line each, with its checks, end-to-end values
and set-up time.  Needs the cell's CUDA devices.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import faults, harness, spec
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 2
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t = time.perf_counter()
            make = faults.make(mode[6:]) if mode.startswith("fault:") else None
            r = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", t,
                                 mode="program" if make else mode, make=make)
            line = {"workload": cell.name, "mode": mode, "seed": seed,
                    "checks": {k: v["value"] for k, v in r["checks"].items()},
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                    "attempted": r["attempted"],
                    "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                    "kind": r["device"]["kind"],
                    "wall_s": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
