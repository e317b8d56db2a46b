#!/usr/bin/env python3
"""Cut quality of the port (`repro_torch`) against the JAX package
(`repro`) at the same seeds, both on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/quality_parity_cpu.py

The two packages draw their tie-break noise from different generators, so
single runs differ; this prints (1) ECO on grid2d(32, 32), k=4, over 32
seeds: mean cut of each and how many seeds agree, and (2) ECO on
grid2d(256, 256), k=16, seeds 1 and 2 (the main path's mesh at 1/16 of its
size; the geometric cut is 6·256 = 1536).  It imports both packages, so it
is a comparison tool and not part of the port.
"""
from __future__ import annotations

import json

import numpy as np

from repro.core import kaffpa as rK
from repro.core.partition import edge_cut, is_feasible
from repro.io import generators as rgen
from repro_torch.core import kaffpa as tK
from repro_torch.io import generators as tgen


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


def main() -> None:
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
