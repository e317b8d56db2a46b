#!/usr/bin/env python3
"""Partition quality of the port (`repro_torch`) against the JAX package
(`repro`) at the same seeds, both on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/quality_parity_cpu.py \
        [--program kaffpa|kahypar]

The two packages draw their tie-break noise from different generators, so
single runs differ.  ``kaffpa`` (the default) prints (1) ECO on
grid2d(32, 32), k=4, over 32 seeds: mean cut of each and how many seeds
agree, and (2) ECO on grid2d(256, 256), k=16, seeds 1 and 2 (the main
path's mesh at 1/16 of its size; the geometric cut is 6·256 = 1536).
``kahypar`` prints ECO km1 on hp400 (planted_hypergraph(400, 600,
blocks=4, seed=11)) at k=4 and k=2 over seeds 1..N (``--seeds``, default
100): mean, median and the count of outliers (km1 above twice the
reference's median) of each, over all N seeds and over seeds 1..30, the
window that tests/test_torch_kahypar.py holds.  It imports both packages,
so it is a comparison tool and not part of the port.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro.core import kaffpa as rK
from repro.core.partition import edge_cut, is_feasible
from repro.io import generators as rgen
from repro_torch.core import kaffpa as tK
from repro_torch.io import generators as tgen
from repro.core.hypergraph import driver as rD
from repro_torch.core.hypergraph import driver as tD
from repro_torch.core.hypergraph import metrics as tM


def cuts(rows, k, seeds):
    g, tg = rgen.grid2d(rows, rows), tgen.grid2d(rows, rows)
    ref, port = [], []
    for s in seeds:
        pr = rK.kaffpa(g, k, 0.03, "eco", seed=s)
        pt = tK.kaffpa(tg, k, 0.03, "eco", seed=s, device="cpu")
        assert is_feasible(g, pr, k, 0.03) and is_feasible(g, pt, k, 0.03)
        ref.append(edge_cut(g, pr))
        port.append(edge_cut(g, pt))
    return np.asarray(ref), np.asarray(port)


def kahypar_km1(k, seeds):
    hp = dict(n=400, m=600, blocks=4, seed=11)
    hg, th = rgen.planted_hypergraph(**hp), tgen.planted_hypergraph(**hp)
    ref, port = [], []
    for s in seeds:
        pr = rD.kahypar(hg, k, 0.03, "eco", seed=s)
        pt = tD.kahypar(th, k, 0.03, "eco", seed=s, device="cpu")
        assert tM.is_feasible(th, pr, k, 0.03)
        assert tM.is_feasible(th, pt, k, 0.03)
        ref.append(tM.connectivity(th, pr))
        port.append(tM.connectivity(th, pt))
    return np.asarray(ref), np.asarray(port)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--program", choices=("kaffpa", "kahypar"),
                    default="kaffpa")
    ap.add_argument("--seeds", type=int, default=100,
                    help="kahypar: seeds 1..N (default 100)")
    args = ap.parse_args()
    if args.program == "kahypar":
        for k in (4, 2):
            ref, port = kahypar_km1(k, range(1, args.seeds + 1))
            for n in sorted({args.seeds, min(30, args.seeds)}):
                r, p = ref[:n], port[:n]
                tail = 2 * np.median(r)
                print(json.dumps({
                    "cell": f"kahypar eco hp400 km1 k={k} seeds 1..{n}",
                    **{f"{name}_{stat}": float(fn(a))
                       for name, a in (("ref", r), ("port", p))
                       for stat, fn in (("mean", np.mean),
                                        ("median", np.median))},
                    "ref_outliers": int((r > tail).sum()),
                    "port_outliers": int((p > tail).sum())}))
        return
    ref, port = cuts(32, 4, range(8, 40))
    print(json.dumps({"cell": "eco grid2d(32,32) k=4 seeds 8..39",
                      "ref_mean": ref.mean(), "port_mean": port.mean(),
                      "same": int((ref == port).sum()),
                      "port_worse": int((port > ref).sum()),
                      "port_better": int((port < ref).sum())}))
    ref, port = cuts(256, 16, (1, 2))
    print(json.dumps({"cell": "eco grid2d(256,256) k=16 seeds 1,2",
                      "ref": ref.tolist(), "port": port.tolist(),
                      "geometric": 6 * 256}))


if __name__ == "__main__":
    main()
