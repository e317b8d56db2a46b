#!/usr/bin/env python3
"""Where the time of the port's kaffpa or kahypar goes, on one NVIDIA GPU.

    python3 tools/profile_torch_kaffpa.py [--program kaffpa|kahypar]
                                          [--out build/profile_<program>.json]

For each cell of the program (kaffpa: ECO on grid2d(1024, 1024) at k=16,
the main path of chip_smoke.py, and ECOSOCIAL on barabasi_albert(65536, 4)
at k=8; kahypar: ECO km1 on rmat_hypergraph(17, seed=1) at k=8, the
hypergraph main path of chip_smoke.py):

1. wall clock of whole runs in turns — plain path, kernel path, kernel
   path, plain path — after one warm-up run, with the partitions checked
   identical;
2. the engine's span breakdown (hierarchy = host coarsening,
   initial_tournament, uncoarsen = refinement) of a kernel-path run;
3. torch.profiler over one kernel-path run: device busy time (the union
   of all device-activity intervals), idle share = 1 - busy / wall, the
   number of device kernels, and the device time by kernel name;
4. cProfile over one kernel-path run: host functions by own time, and the
   cumulative time of the host steps named in ``HOST_STEPS``.

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
from repro_torch.core.hypergraph import driver as HD  # noqa: E402
from repro_torch.core.hypergraph import metrics as HM  # noqa: E402
from repro_torch.core.partition import edge_cut, is_feasible  # noqa: E402
from repro_torch.io.generators import (barabasi_albert, grid2d,  # noqa: E402
                                       planted_hypergraph, rmat_hypergraph)
from repro_torch.kernels import lp_affinity, pin_affinity  # noqa: E402
from chip_smoke import card_line, span_seconds  # noqa: E402

DEVICE = "cuda"


@dataclasses.dataclass
class Program:
    """How to run one partitioner on one instance and score the result."""

    medium: type
    presets: dict
    launches: str                        # the kernel's launch counter
    objective: callable                  # (instance, part) -> int
    feasible: callable                   # (instance, part, k, eps) -> bool
    cells: dict                          # name -> (make, preset, k)
    warmup: callable                     # () -> instance for a warm-up run


PROGRAMS = {
    "kaffpa": Program(
        K.GraphMedium, K.PRESETS, lp_affinity.LAUNCHES, edge_cut,
        is_feasible, {
            "eco_grid1024_k16": (lambda: grid2d(1024, 1024), "eco", 16),
            "ecosocial_ba64k_k8": (lambda: barabasi_albert(65536, 4, seed=1),
                                   "ecosocial", 8)},
        lambda: grid2d(64, 64)),
    "kahypar": Program(
        HD.HypergraphMedium, HD.PRESETS, pin_affinity.LAUNCHES,
        HM.connectivity, HM.is_feasible, {
            "eco_rmat17_k8": (lambda: rmat_hypergraph(17, seed=1), "eco", 8)},
        lambda: planted_hypergraph(2048, 3072, blocks=8, seed=1)),
}
#: host steps whose cumulative time the cProfile pass reports
HOST_STEPS = ("clique_expansion", "contract", "to_ell_h", "to_pincoo",
              "to_ell", "to_coo", "heavy_edge_matching", "greedy_growing",
              "bfs_grow_bisection")


def run(prog, g, preset, k, use_kernel, rec=None):
    cfg = dataclasses.replace(prog.presets[preset], use_kernel=use_kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part = ML.run(prog.medium(g, cfg, recorder=rec, device=DEVICE), k,
                  0.03, 1)
    torch.cuda.synchronize()
    return part, time.perf_counter() - t0


def device_profile(prog, g, preset, k):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = run(prog, g, preset, k, None)
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


def host_profile(prog, g, preset, k):
    prof = cProfile.Profile()
    prof.enable()
    run(prog, g, preset, k, None)
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:15]
    steps: dict = {}
    for (f, ln, fn), (_, _, _, ct, _) in st.stats.items():
        if fn in HOST_STEPS and "repro_torch" in f:
            key = f"{Path(f).parent.name}/{Path(f).name}:{fn}"
            steps[key] = steps.get(key, 0.0) + ct
    return ([[f"{Path(f).name}:{ln}:{fn}", tt, ct]
             for (f, ln, fn), (_, _, tt, ct, _) in rows], steps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--program", choices=sorted(PROGRAMS), default="kaffpa")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = Path(args.out or ROOT / "build" / f"profile_{args.program}.json")
    if not torch.cuda.is_available():
        print("error: needs CUDA", file=sys.stderr)
        return 2
    prog = PROGRAMS[args.program]
    card = card_line()
    report = {"card": card, "torch": torch.__version__,
              "program": args.program, "cells": {}}
    first = next(iter(prog.cells.values()))
    run(prog, prog.warmup(), first[1], first[2], None)     # warm-up
    for name, (make, preset, k) in prog.cells.items():
        g = make()
        walls = {"plain": [], "kernel": []}
        parts = []
        for path in ("plain", "kernel", "kernel", "plain"):
            part, wall = run(prog, g, preset, k, path == "kernel")
            walls[path].append(wall)
            parts.append(part)
        same = all(np.array_equal(parts[0], p) for p in parts[1:])
        rec = obs.Recorder(name)
        obs.metrics.reset(prog.launches)
        part, wall = run(prog, g, preset, k, None, rec)
        launches = int(obs.metrics.get(prog.launches))
        top, steps = host_profile(prog, g, preset, k)
        cell = {
            "n": g.n, "m": g.m, "k": k, "preset": preset,
            "objective": int(prog.objective(g, part)),
            "feasible": bool(prog.feasible(g, part, k, 0.03)),
            "identical_paths": bool(same), "wall_s": walls,
            "recorded_wall_s": wall,
            "spans_s": span_seconds(rec, ("hierarchy", "initial_tournament",
                                          "uncoarsen")),
            "levels": int(rec.counters().get("engine/levels", 0)),
            "kernel_launches": launches,
            "device": device_profile(prog, g, preset, k),
            "host_top_tottime_s": top,
            "host_steps_cumtime_s": steps,
        }
        report["cells"][name] = cell
        print(f"{name}: {json.dumps(cell)}", flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"card": card, "out": str(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
