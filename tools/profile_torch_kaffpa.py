#!/usr/bin/env python3
"""Where the time of the port's kaffpa goes, on one NVIDIA GPU.

    python3 tools/profile_torch_kaffpa.py [--out chiprun_out/profile_kaffpa.json]

For each cell (ECO on grid2d(1024, 1024) at k=16, the main path of
chip_smoke.py; ECOSOCIAL on barabasi_albert(65536, 4) at k=8):

1. wall clock of whole runs in turns — plain path, kernel path, kernel
   path, plain path — after one warm-up run, with the partitions checked
   identical;
2. the engine's span breakdown (hierarchy = host coarsening,
   initial_tournament, uncoarsen = refinement) of a kernel-path run;
3. torch.profiler over one kernel-path run: device busy time (the union
   of all device-activity intervals), idle share = 1 - busy / wall, the
   number of device kernels, and the device time by kernel name;
4. cProfile over one kernel-path run: host functions by own time.

Prints one JSON object and writes it to ``--out``.  Needs CUDA; imports
nothing of jax or of the JAX package.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import json
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core import kaffpa as K  # noqa: E402
from repro_torch.core import multilevel as ML  # noqa: E402
from repro_torch.core.partition import edge_cut, is_feasible  # noqa: E402
from repro_torch.io.generators import barabasi_albert, grid2d  # noqa: E402
from repro_torch.kernels.lp_affinity import LAUNCHES  # noqa: E402
from chip_smoke import card_line, span_seconds  # noqa: E402

DEVICE = "cuda"
CELLS = {
    "eco_grid1024_k16": (lambda: grid2d(1024, 1024), "eco", 16),
    "ecosocial_ba64k_k8": (lambda: barabasi_albert(65536, 4, seed=1),
                           "ecosocial", 8),
}


def run(g, preset, k, use_kernel, rec=None):
    cfg = dataclasses.replace(K.PRESETS[preset], use_kernel=use_kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part = ML.run(K.GraphMedium(g, cfg, recorder=rec, device=DEVICE), k,
                  0.03, 1)
    torch.cuda.synchronize()
    return part, time.perf_counter() - t0


def device_profile(g, preset, k):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = run(g, preset, k, None)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"device": "not measured (the profiler saw no device time)"}
    busy, cur_s, cur_e = 0.0, None, None
    by_name: dict = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"profiled_wall_s": wall, "device_busy_s": busy / 1e6,
            "device_idle_share": 1.0 - busy / 1e6 / wall,
            "device_activities": len(spans),
            "top_device_s": [[n[:90], t / 1e6] for n, t in top]}


def host_profile(g, preset, k):
    prof = cProfile.Profile()
    prof.enable()
    run(g, preset, k, None)
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:15]
    return [[f"{Path(f).name}:{ln}:{fn}", tt, ct]
            for (f, ln, fn), (_, _, tt, ct, _) in rows]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "profile_kaffpa.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: needs CUDA", file=sys.stderr)
        return 2
    card = card_line()
    report = {"card": card, "torch": torch.__version__, "cells": {}}
    run(grid2d(64, 64), "eco", 16, None)                   # warm-up
    for name, (make, preset, k) in CELLS.items():
        g = make()
        walls = {"plain": [], "kernel": []}
        parts = []
        for path in ("plain", "kernel", "kernel", "plain"):
            part, wall = run(g, preset, k, path == "kernel")
            walls[path].append(wall)
            parts.append(part)
        same = all(np.array_equal(parts[0], p) for p in parts[1:])
        rec = obs.Recorder(name)
        obs.metrics.reset(LAUNCHES)
        part, wall = run(g, preset, k, None, rec)
        cell = {
            "n": g.n, "m": g.m, "k": k, "preset": preset,
            "cut": int(edge_cut(g, part)),
            "feasible": bool(is_feasible(g, part, k, 0.03)),
            "identical_paths": bool(same), "wall_s": walls,
            "recorded_wall_s": wall,
            "spans_s": span_seconds(rec, ("hierarchy", "initial_tournament",
                                          "uncoarsen")),
            "levels": int(rec.counters().get("engine/levels", 0)),
            "kernel_launches": int(obs.metrics.get(LAUNCHES)),
            "device": device_profile(g, preset, k),
            "host_top_tottime_s": host_profile(g, preset, k),
        }
        report["cells"][name] = cell
        print(f"{name}: {json.dumps(cell)}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"card": card, "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
