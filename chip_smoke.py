#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from this checkout, holds each against its plain
PyTorch version, drives kaffpa end to end at a 1M-vertex mesh and kahypar
end to end at a 131k-vertex power-law hypergraph, and prints what it
measured.  Any failure exits non-zero before the result line.  Phases:

 1. The card's name and power limit; build kernels/csrc/lp_affinity.cu and
    kernels/csrc/pin_count.cu for sm_90a (one nvcc each, started together)
    and print the build times.
 2. lp_affinity against ``ref.affinity_ref`` at the sweep shapes of
    tests/test_kernels.py, B = 1 and 4: integer weights exactly, float
    weights within 1e-5.
 3. The kaffpa main path: ``interface.kaffpa`` with mode ECO on
    grid2d(1024, 1024) (1,048,576 vertices, 2,095,104 edges), nparts=16,
    imbalance=0.03, seed=1.  The kernel's launch count is set to 0 just
    before and read just after; the partition must be feasible and the
    count > 0.
 4. The same run with ``use_kernel=False`` (the plain COO path on the
    card): the partition must be identical and launch nothing.
 5. ECOSOCIAL on barabasi_albert(65536, 4) at k=8 (LP-clustering
    coarsening on the card): feasible, and the kernel launched.
 6. lp_affinity at the kaffpa main path's level-0 shape (the run's own ELL
    view and partition, B = 1 and 4): agreement, then times of the kernel,
    the plain version and one PyTorch call computing the same function
    (``scatter_add_``, timed only), beside the least time the card could
    take for the bytes this run's inputs need (padding slots' ids are not
    counted: no version needs them).
 7. pin_count against ``ref.pin_count_ref`` at the sweep shapes of
    tests/test_hypergraph.py plus k = 8, B = 1 and 4: 0/1 masks exactly,
    float masks within 1e-5.
 8. The kahypar main path: ``interface.kahypar`` with mode ECO, objective
    km1, on rmat_hypergraph(17, seed=1) (131,072 vertices, 131,072 nets,
    707,640 pins), nparts=8, imbalance=0.03, seed=1.  The pin-count
    kernel's launch count is set to 0 just before and read just after; the
    partition must be feasible and the count > 0.
 9. The same run with ``use_kernel=False``: the identical partition, and
    no launch.
10. The cut-net objective on rmat_hypergraph(14, seed=2) at k=4: feasible,
    the kernel launched, and the cut below a random partition's.
11. pin_count at the kahypar main path's level-0 shape (the run's own
    ELL-H view and partition, B = 1 and 4): agreement, then times of the
    kernel, the plain version and ``scatter_add_``, beside the bound.

It prints a JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``.  No jax and nothing of the JAX package is imported.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): device memory and f32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
SWEEP = [(128, 8, 2), (256, 24, 5), (128, 16, 130), (384, 40, 17)]
# (vertices, nets, k) of tests/test_hypergraph.py's pin-count sweep, + k=8
PIN_SWEEP = [(100, 150, 2), (300, 500, 5), (64, 90, 130), (200, 260, 8)]


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: int, adds: int):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the additions over
    the f32 rate, and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, adds / PEAK_F32_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def affinity_inputs(torch, dev, n_pad, dmax, k, b, integer, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    nbr = torch.randint(0, n_pad, (n_pad, dmax), generator=g, device=dev,
                        dtype=torch.int32)
    live = torch.rand((n_pad, dmax), generator=g, device=dev) > 0.3
    w = (torch.randint(1, 10, (n_pad, dmax), generator=g, device=dev).float()
         if integer else torch.rand((n_pad, dmax), generator=g, device=dev))
    labels = torch.randint(0, k, (b, n_pad), generator=g, device=dev,
                           dtype=torch.int32)
    return nbr, (w * live).contiguous(), labels


def compare(torch, nbr, wgt, labels, k, integer) -> float:
    """Kernel vs plain version on the same inputs; returns max |diff|."""
    from repro_torch.kernels import lp_affinity, ref
    got = lp_affinity.affinity_cuda(nbr, wgt, labels, k)
    want = ref.affinity_ref(nbr, wgt, labels, k)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"shape {tuple(got.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    tol = 0.0 if integer else 1e-5
    check(err <= tol, f"lp_affinity disagrees with affinity_ref at "
          f"{tuple(labels.shape)}x{tuple(nbr.shape)} k={k}: {err} > {tol}")
    return err


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def span_seconds(rec, names) -> dict:
    """Host-clock seconds of the named spans, summed per name."""
    open_ts, total = {}, {n: 0.0 for n in names}
    for ev in rec.events:
        if ev.get("name") not in total:
            continue
        key = (ev["name"], ev["tid"], ev.get("depth"))
        if ev["ph"] == "B":
            open_ts[key] = ev["ts"]
        elif ev["ph"] == "E" and key in open_ts:
            total[ev["name"]] += (ev["ts"] - open_ts.pop(key)) / 1e6
    return total


def run_kaffpa(torch, g, k, mode, seed, dev, use_kernel=None):
    """One kaffpa run with the launch count zeroed just before and read
    just after.  ``use_kernel=None`` goes through the C-API entry point a
    user calls; ``False`` runs the same engine with the plain path."""
    from repro_torch import obs
    from repro_torch.core import interface, kaffpa as K, multilevel as ML
    from repro_torch.core.partition import edge_cut
    from repro_torch.kernels.lp_affinity import LAUNCHES
    rec = obs.Recorder("kaffpa")
    torch.cuda.synchronize()
    obs.metrics.reset(LAUNCHES)
    t0 = time.perf_counter()
    if use_kernel is None:
        cut, part = interface.kaffpa(g.n, None, g.xadj, None, g.adjncy, k,
                                     0.03, seed=seed, mode=mode,
                                     report=rec, device=dev)
    else:
        cfg = dataclasses.replace(K.PRESETS[interface._MODE_NAMES[mode]],
                                  use_kernel=use_kernel)
        part = ML.run(K.GraphMedium(g, cfg, recorder=rec, device=dev), k,
                      0.03, seed)
        cut = edge_cut(g, part)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = int(obs.metrics.get(LAUNCHES))
    return cut, part, wall, launches, rec


def pin_inputs(torch, dev, n, m, k, b, integer, seed):
    """A random hypergraph's ELL-H view on the card, with 0/1 masks or
    (``integer=False``) float masks on the real slots, and B label rows."""
    from repro_torch.core.hypergraph.container import to_ell_h
    from repro_torch.io.generators import random_hypergraph
    ell = to_ell_h(random_hypergraph(n, m, seed=n + k, wmax=4), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = ell.pin_mask
    if not integer:
        mask = (mask * torch.rand(mask.shape, generator=g,
                                  device=dev)).contiguous()
    labels = torch.randint(0, k, (b, ell.n_pad), generator=g, device=dev,
                           dtype=torch.int32)
    return ell.pins, mask, ell.netw, labels


def compare_pins(torch, pins, mask, netw, labels, k, integer) -> float:
    """pin_count kernel vs plain version on the same inputs; returns max
    |diff| over both outputs."""
    from repro_torch.kernels import pin_affinity, ref
    got = pin_affinity.pin_count_cuda(pins, mask, netw, labels, k)
    want = ref.pin_count_ref(pins, mask, netw, labels, k)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"shape {tuple(g.shape)}")
        err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
    tol = 0.0 if integer else 1e-5
    check(err <= tol, f"pin_count disagrees with pin_count_ref at "
          f"{tuple(labels.shape)}x{tuple(pins.shape)} k={k}: {err} > {tol}")
    return err


def run_kahypar(torch, hg, k, mode, objective, seed, dev, use_kernel=None):
    """One kahypar run with the pin-count launch count zeroed just before
    and read just after.  ``use_kernel=None`` goes through the C-API entry
    point a user calls; ``False`` runs the same engine on the plain path."""
    from repro_torch import obs
    from repro_torch.core import interface, multilevel as ML
    from repro_torch.core.hypergraph import driver as D
    from repro_torch.core.hypergraph.metrics import connectivity, cut_net
    from repro_torch.kernels.pin_affinity import LAUNCHES
    rec = obs.Recorder("kahypar")
    torch.cuda.synchronize()
    obs.metrics.reset(LAUNCHES)
    t0 = time.perf_counter()
    if use_kernel is None:
        obj, part = interface.kahypar(hg.n, hg.m, None, None, hg.eptr,
                                      hg.eind, k, 0.03, seed=seed, mode=mode,
                                      objective=objective, report=rec,
                                      device=dev)
    else:
        cfg = dataclasses.replace(D.PRESETS[interface._MODE_NAMES[mode]],
                                  use_kernel=use_kernel)
        part = ML.run(D.HypergraphMedium(hg, cfg, objective, recorder=rec,
                                         device=dev), k, 0.03, seed)
        obj = (connectivity if objective == "km1" else cut_net)(hg, part)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = int(obs.metrics.get(LAUNCHES))
    return obj, part, wall, launches, rec


def kahypar_phases(torch, np, dev, card) -> dict:
    """Phases 7-11; returns the pin_count row of the kernels line."""
    from repro_torch.core import interface
    from repro_torch.core.hypergraph.container import to_ell_h
    from repro_torch.core.hypergraph.initial import random_partition
    from repro_torch.core.hypergraph.metrics import (balance, connectivity,
                                                     cut_net, is_feasible)
    from repro_torch.core.hypergraph.refine import k_bucket
    from repro_torch.io.generators import rmat_hypergraph
    from repro_torch.kernels import pin_affinity, ref

    # -- 7. kernel vs plain version at the sweep shapes --------------------
    max_err = 0.0
    for (n, m, k) in PIN_SWEEP:
        for b in (1, 4):
            for integer in (True, False):
                ins = pin_inputs(torch, dev, n, m, k, b, integer,
                                 seed=n + m + k + b)
                max_err = max(max_err, compare_pins(torch, *ins, k, integer))
    log(f"sweep: pin_count == pin_count_ref at {len(PIN_SWEEP)} shapes x "
        f"B=1,4 x int/float masks (max |err| {max_err:g})")

    # -- 8. the kahypar main path at real size ----------------------------
    k_main = 8
    hg = rmat_hypergraph(17, seed=1)
    log(f"hypergraph rmat_hypergraph(17, seed=1): n={hg.n} m={hg.m} "
        f"pins={hg.pins} max_net={int(hg.net_sizes().max())} "
        f"max_degree={int(hg.vertex_degrees().max())}")
    km1, part, wall, launches, rec = run_kahypar(
        torch, hg, k_main, interface.ECO, "km1", 1, dev)
    feas = is_feasible(hg, part, k_main, 0.03)
    ctr = rec.counters()
    spans = span_seconds(rec, ("hierarchy", "initial_tournament",
                               "uncoarsen"))
    rnd = random_partition(hg, k_main, seed=0)
    log(f"main path kahypar ECO km1 k={k_main}: km1={km1} (random "
        f"partition {connectivity(hg, rnd)}) "
        f"balance={balance(hg, part, k_main):.4f} feasible={feas} "
        f"wall_s={wall:.3f} levels={int(ctr.get('engine/levels', 0))} "
        f"launches={launches} view_builds="
        f"{int(ctr.get('engine/view_builds', 0))} spans_s="
        f"{json.dumps({n: round(s, 3) for n, s in spans.items()})}")
    check(feas, "kahypar main path partition infeasible")
    check(launches > 0, "kahypar main path never launched pin_count")
    main_launches = launches

    # -- 9. the same run on the plain path ---------------------------------
    km1_2, part2, wall2, launches2, _ = run_kahypar(
        torch, hg, k_main, interface.ECO, "km1", 1, dev, use_kernel=False)
    log(f"plain path kahypar ECO km1 k={k_main}: km1={km1_2} "
        f"wall_s={wall2:.3f} launches={launches2}")
    check(launches2 == 0, "use_kernel=False launched pin_count")
    check(np.array_equal(part, part2),
          "kahypar kernel path and plain path partitions differ")

    # -- 10. the cut-net objective -----------------------------------------
    hg14 = rmat_hypergraph(14, seed=2)
    cut, part3, wall3, launches3, _ = run_kahypar(
        torch, hg14, 4, interface.ECO, "cut", 1, dev)
    rnd_cut = cut_net(hg14, random_partition(hg14, 4, seed=0))
    feas3 = is_feasible(hg14, part3, 4, 0.03)
    log(f"cut path kahypar ECO cut rmat_hypergraph(14, seed=2) k=4: "
        f"cut={cut} (random partition {rnd_cut}) "
        f"balance={balance(hg14, part3, 4):.4f} feasible={feas3} "
        f"wall_s={wall3:.3f} launches={launches3}")
    check(feas3, "cut-objective partition infeasible")
    check(launches3 > 0, "cut-objective run never launched pin_count")
    check(cut < rnd_cut, "cut objective not below a random partition's")

    # -- 11. the kernel at the main path's level-0 shape ------------------
    ell = to_ell_h(hg, device=dev)
    k_pad = k_bucket(k_main)
    e_pad, pmax = ell.pins.shape
    lab1 = torch.zeros(1, ell.n_pad, dtype=torch.int32, device=dev)
    lab1[0, :hg.n] = torch.from_numpy(part.astype(np.int32)).to(dev)
    rows_out = {}
    for b in (1, 4):
        labels = lab1.expand(b, -1).contiguous()
        if b > 1:      # other rows: other candidate partitions
            gen = torch.Generator(device=dev).manual_seed(b)
            labels[1:] = torch.randint(0, k_main, (b - 1, ell.n_pad),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)
        max_err = max(max_err, compare_pins(torch, ell.pins, ell.pin_mask,
                                            ell.netw, labels, k_pad, True))
        fgen = torch.Generator(device=dev).manual_seed(7 + b)
        fmask = (ell.pin_mask * torch.rand(ell.pin_mask.shape, device=dev,
                                           generator=fgen)).contiguous()
        max_err = max(max_err, compare_pins(torch, ell.pins, fmask, ell.netw,
                                            labels, k_pad, False))
        pins_l = ell.pins.long()

        def library():
            return torch.zeros(b, e_pad, k_pad, device=dev).scatter_add_(
                2, labels.long()[:, pins_l], ell.pin_mask.expand(b, -1, -1))

        check(torch.equal(library(), pin_affinity.pin_count_cuda(
            ell.pins, ell.pin_mask, ell.netw, labels, k_pad)[0]),
              "scatter_add_ yardstick disagrees with the kernel")
        ms = cuda_ms(torch, lambda: pin_affinity.pin_count_cuda(
            ell.pins, ell.pin_mask, ell.netw, labels, k_pad))
        plain_ms = cuda_ms(torch, lambda: ref.pin_count_ref(
            ell.pins, ell.pin_mask, ell.netw, labels, k_pad), iters=5)
        library_ms = cuda_ms(torch, library, iters=5)
        # what the function must move: the whole mask (it marks the live
        # slots), the pin ids of live slots only, netw of nets with a live
        # pin (any other net's score is 0 whatever its weight), the labels,
        # and both outputs
        live = ell.pin_mask != 0
        nbytes = (ell.pin_mask.numel() * 4 + int(live.sum()) * 4
                  + int(live.any(1).sum()) * 4 + labels.numel() * 4
                  + 2 * b * e_pad * k_pad * 4)
        adds = b * int(live.sum())
        bms, by = bound_ms(nbytes, adds)
        rows_out[b] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bms, bound_by=by)
        log(f"pin_count B={b} e_pad={e_pad} pmax={pmax} k={k_pad} "
            f"n_pad={ell.n_pad}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, scatter_add_ {library_ms:.4f} ms, bound {bms:.4f} ms "
            f"({nbytes} bytes at {PEAK_BYTES_PER_S / 1e12} TB/s) [{card}]")
    main = rows_out[1]    # level-0 refinement launches one row
    return {"name": "pin_count", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pin_count.cu",
            "replaces": "src/repro/kernels/pin_affinity.py:33",
            "launches": main_launches, "max_abs_err": max_err,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": [1, e_pad, pmax, k_pad, ell.n_pad]}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"error: {SRC / 'repro_torch'} not found: run chip_smoke.py "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false: chip_smoke.py "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from repro_torch.core import interface
    from repro_torch.core.csr import to_coo, to_ell
    from repro_torch.core.partition import balance, is_feasible
    from repro_torch.io.generators import barabasi_albert, grid2d
    from repro_torch.kernels import lp_affinity, pin_affinity, ref

    # -- 1. card, build -----------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()

    def timed_build(build):
        lib = build()
        return lib, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(timed_build, b)
                  for b in (lp_affinity.build, pin_affinity.build)]
        for fut in builds:
            lib, secs = fut.result()
            log(f"built {lib.relative_to(ROOT)} in {secs:.3f} s")

    # -- 2. kernel vs plain version at the sweep shapes ------------------
    max_err = 0.0
    for (n_pad, dmax, k) in SWEEP:
        for b in (1, 4):
            for integer in (True, False):
                ins = affinity_inputs(torch, dev, n_pad, dmax, k, b, integer,
                                      seed=n_pad + dmax + k + b)
                max_err = max(max_err, compare(torch, *ins, k, integer))
    log(f"sweep: lp_affinity == affinity_ref at {len(SWEEP)} shapes x "
        f"B=1,4 x int/float weights (max |err| {max_err:g})")

    # -- 3. the main path at real size -------------------------------------
    rows = cols = 1024
    k_main = 16
    g = grid2d(rows, cols)
    log(f"graph grid2d({rows},{cols}): n={g.n} m={g.m}")
    cut, part, wall, launches, rec = run_kaffpa(torch, g, k_main,
                                                interface.ECO, 1, dev)
    feas = is_feasible(g, part, k_main, 0.03)
    ctr = rec.counters()
    spans = span_seconds(rec, ("hierarchy", "initial_tournament",
                               "uncoarsen"))
    log(f"main path kaffpa ECO k={k_main}: cut={cut} (geometric 4x4 cut "
        f"6144) balance={balance(g, part, k_main):.4f} feasible={feas} "
        f"wall_s={wall:.3f} levels={int(ctr.get('engine/levels', 0))} "
        f"launches={launches} view_builds="
        f"{int(ctr.get('engine/view_builds', 0))} spans_s="
        f"{json.dumps({n: round(s, 3) for n, s in spans.items()})}")
    check(feas, "main path partition infeasible")
    check(launches > 0, "main path never launched the lp_affinity kernel")
    main_launches = launches

    # -- 4. the same run on the plain path ---------------------------------
    cut2, part2, wall2, launches2, _ = run_kaffpa(
        torch, g, k_main, interface.ECO, 1, dev, use_kernel=False)
    log(f"plain path kaffpa ECO k={k_main}: cut={cut2} wall_s={wall2:.3f} "
        f"launches={launches2}")
    check(launches2 == 0, "use_kernel=False launched the kernel")
    check(np.array_equal(part, part2),
          "kernel path and plain path partitions differ")

    # -- 5. social preset: LP-clustering coarsening on the card -----------
    ba = barabasi_albert(65536, 4, seed=1)
    cut3, part3, wall3, launches3, rec3 = run_kaffpa(
        torch, ba, 8, interface.ECOSOCIAL, 1, dev)
    feas3 = is_feasible(ba, part3, 8, 0.03)
    log(f"social path kaffpa ECOSOCIAL barabasi_albert(65536,4) k=8: "
        f"cut={cut3} balance={balance(ba, part3, 8):.4f} feasible={feas3} "
        f"wall_s={wall3:.3f} levels="
        f"{int(rec3.counters().get('engine/levels', 0))} "
        f"launches={launches3}")
    check(feas3, "ECOSOCIAL partition infeasible")
    check(launches3 > 0, "ECOSOCIAL run never launched the kernel")

    # -- 6. the kernel at the main path's level-0 shape -------------------
    coo = to_coo(g, device=dev)
    ell = to_ell(g, row_tile=coo.n_pad, device=dev)
    n_pad, dmax = ell.nbr.shape
    lab1 = torch.zeros(1, n_pad, dtype=torch.int32, device=dev)
    lab1[0, :g.n] = torch.from_numpy(part.astype(np.int32)).to(dev)
    rows_out = {}
    for b in (1, 4):
        labels = lab1.expand(b, -1).contiguous()
        if b > 1:      # other rows: other candidate partitions
            gen = torch.Generator(device=dev).manual_seed(b)
            labels[1:] = torch.randint(0, k_main, (b - 1, n_pad),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)
        max_err = max(max_err, compare(torch, ell.nbr, ell.wgt, labels,
                                       k_main, integer=True))
        fnbr, fwgt, flab = affinity_inputs(torch, dev, n_pad, dmax, k_main,
                                           b, integer=False, seed=7 + b)
        max_err = max(max_err, compare(torch, fnbr, fwgt, flab, k_main,
                                       integer=False))
        nbr_l = ell.nbr.long()

        def library():
            return torch.zeros(b, n_pad, k_main, device=dev).scatter_add_(
                2, labels.long()[:, nbr_l], ell.wgt.expand(b, -1, -1))

        check(torch.equal(library(), lp_affinity.affinity_cuda(
            ell.nbr, ell.wgt, labels, k_main)), "scatter_add_ yardstick "
              "disagrees with the kernel")
        ms = cuda_ms(torch, lambda: lp_affinity.affinity_cuda(
            ell.nbr, ell.wgt, labels, k_main))
        plain_ms = cuda_ms(torch, lambda: ref.affinity_ref(
            ell.nbr, ell.wgt, labels, k_main), iters=5)
        library_ms = cuda_ms(torch, library, iters=5)
        # what the function must move: the whole weight array (it marks
        # the live slots), the neighbour ids of live slots only, the labels
        # and the output
        live = int((ell.wgt != 0).sum())
        nbytes = (ell.wgt.numel() * 4 + live * 4 + labels.numel() * 4
                  + b * n_pad * k_main * 4)
        bms, by = bound_ms(nbytes, b * live)
        rows_out[b] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bms, bound_by=by)
        log(f"lp_affinity B={b} n_pad={n_pad} dmax={dmax} k={k_main}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scatter_add_ "
            f"{library_ms:.4f} ms, bound {bms:.4f} ms ({nbytes} bytes "
            f"at {PEAK_BYTES_PER_S / 1e12} TB/s) [{card}]")

    main = rows_out[1]    # level-0 refinement launches one row
    pin_row = kahypar_phases(torch, np, dev, card)
    log(json.dumps({"kernels": [{
        "name": "lp_affinity", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lp_affinity.cu",
        "replaces": "src/repro/kernels/lp_affinity.py:30",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": [1, n_pad, dmax, k_main]}, pin_row]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
