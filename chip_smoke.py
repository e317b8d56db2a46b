#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from this checkout, holds it against its plain
PyTorch version, drives kaffpa end to end at a 1M-vertex mesh, and prints
what it measured.  Any failure exits non-zero before the result line.
Phases:

 1. The card's name and power limit; build kernels/csrc/lp_affinity.cu for
    sm_90a and print the build time.
 2. The kernel against ``ref.affinity_ref`` at the sweep shapes of
    tests/test_kernels.py, B = 1 and 4: integer weights exactly, float
    weights within 1e-5.
 3. The main path: ``interface.kaffpa`` with mode ECO on grid2d(1024, 1024)
    (1,048,576 vertices, 2,095,104 edges), nparts=16, imbalance=0.03,
    seed=1.  The kernel's launch count is set to 0 just before and read
    just after; the partition must be feasible and the count > 0.
 4. The same run with ``use_kernel=False`` (the plain COO path on the
    card): the partition must be identical and launch nothing.
 5. ECOSOCIAL on barabasi_albert(65536, 4) at k=8 (LP-clustering
    coarsening on the card): feasible, and the kernel launched.
 6. The kernel at the main path's level-0 shape (the run's own ELL view
    and partition, B = 1 and 4): agreement, then times of the kernel, the
    plain version and one PyTorch call computing the same function
    (``scatter_add_``, timed only), beside the least time the card could
    take.

It prints a JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``.  No jax and nothing of the JAX package is imported.
"""
from __future__ import annotations

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


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from repro_torch.kernels import lp_affinity, ref

    # -- 1. card, build -----------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = lp_affinity.build()
    log(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.3f} s")

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
        nbytes = (ell.nbr.numel() * 4 + ell.wgt.numel() * 4
                  + labels.numel() * 4 + b * n_pad * k_main * 4)
        adds = b * int((ell.wgt != 0).sum())
        bound_ms = max(nbytes / PEAK_BYTES_PER_S, adds / PEAK_F32_PER_S) * 1e3
        rows_out[b] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bytes=nbytes)
        log(f"lp_affinity B={b} n_pad={n_pad} dmax={dmax} k={k_main}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scatter_add_ "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes "
            f"at {PEAK_BYTES_PER_S / 1e12} TB/s) [{card}]")

    main = rows_out[1]    # level-0 refinement launches one row
    log(json.dumps({"kernels": [{
        "name": "lp_affinity", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lp_affinity.cu",
        "replaces": "src/repro/kernels/lp_affinity.py:30",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "library_ms": main["library_ms"],
        "shape": [1, n_pad, dmax, k_main]}]}))
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
