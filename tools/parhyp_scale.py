#!/usr/bin/env python3
"""Wall and peak device memory of one ``parhyp`` call at scale.

    python3 tools/parhyp_scale.py [--scale 20] [--k 8] [--out FILE]

Runs ``interface.parhyp`` (preset fast, km1, seed 1) on the card, a world
of one, on ``rmat_hypergraph(scale, seed=1)`` (scale 20: 1,048,576
vertices and nets) and prints one JSON line: the card's name and power
limit, the hypergraph's size, km1, feasibility, the seconds to generate
the input, the call's wall (host clock, ending in a device sync), its
peak device memory, the device levels and the pin-count launches.  With
``--out`` the line is also written to that file.  Needs a card: without
one it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("error: parhyp_scale.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch import obs
    from repro_torch.core import interface
    from repro_torch.core.hypergraph.metrics import is_feasible
    from repro_torch.io.generators import rmat_hypergraph
    from repro_torch.kernels.pin_affinity import LAUNCHES
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    hg = rmat_hypergraph(args.scale, seed=1)
    gen_s = time.perf_counter() - t0
    rec = obs.Recorder("parhyp")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.metrics.reset(LAUNCHES)
    t0 = time.perf_counter()
    km1, part = interface.parhyp(hg.n, hg.m, None, None, hg.eptr, hg.eind,
                                 args.k, 0.03, seed=1,
                                 preconfiguration="fast", report=rec,
                                 device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ctr = rec.counters()
    line = json.dumps({
        "card": card, "scale": args.scale, "n": hg.n, "m": hg.m,
        "pins": hg.pins, "k": args.k, "km1": int(km1),
        "feasible": bool(is_feasible(hg, part, args.k, 0.03)),
        "generate_s": gen_s, "wall_s": wall,
        "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
        "device_levels": int(ctr.get("parhyp/device_levels", 0)),
        "repairs": int(ctr.get("parhyp/repairs", 0)),
        "pin_count_launches": int(obs.metrics.get(LAUNCHES))})
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
