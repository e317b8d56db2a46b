#!/usr/bin/env python3
"""The process mapping's QAP against the identity mapping, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/mapping_identity_cpu.py \
        [--side 128] [--seeds 3] [--package both|port|ref]

For seeds 1..N it partitions grid2d(side, side) into 16 blocks (kaffpa
ECO, ε = 0.03), maps the blocks onto the hierarchy [4, 4] with distances
[1, 10] (`mapping.kaffpa_with_mapping`, the call behind
``interface.process_mapping``), and prints one JSON line per seed and
package: the mapping's QAP, the identity mapping's QAP on the same
partition (block b on processor b) and their ratio.  A port row also
holds the QAP of the reference's mapping (``process_mapping``) on the
port's communication matrix at that seed, so the two mappings are
compared on the same input.  It imports both packages, so it is a
comparison tool and not part of the port.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

HIERARCHY, DISTANCES, K = [4, 4], [1, 10], 16


def comm_matrix(g, part) -> np.ndarray:
    src = g.edge_sources()
    ext = part[src] != part[g.adjncy]
    comm = np.zeros((K, K), dtype=np.int64)
    np.add.at(comm, (part[src[ext]], part[g.adjncy[ext]]), g.adjwgt[ext])
    return comm


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--package", choices=("both", "port", "ref"),
                    default="both")
    args = ap.parse_args()
    packages = ["port", "ref"] if args.package == "both" else [args.package]
    for pkg in packages:
        if pkg == "port":
            from repro_torch.core import mapping as M
            from repro_torch.io.generators import grid2d
            kw = dict(device="cpu")
        else:
            from repro.core import mapping as M
            from repro.io.generators import grid2d
            kw = {}
        g = grid2d(args.side, args.side)
        dist = M.processor_distance_matrix(HIERARCHY, DISTANCES)
        for seed in range(1, args.seeds + 1):
            part, procs, qap = M.kaffpa_with_mapping(
                g, HIERARCHY, DISTANCES, 0.03, "eco", seed=seed, **kw)
            comm = comm_matrix(g, part)
            identity = M.qap_cost(comm, dist, np.arange(K))
            row = {"package": pkg, "side": args.side, "seed": seed,
                   "qap": int(qap), "identity_qap": int(identity),
                   "ratio": qap / identity}
            if pkg == "port":
                from repro.core import mapping as RM
                row["ref_qap_same_comm"] = int(RM.qap_cost(
                    comm, dist, RM.process_mapping(comm, HIERARCHY,
                                                   DISTANCES, seed=seed)))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
