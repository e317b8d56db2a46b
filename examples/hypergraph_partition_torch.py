"""Hypergraph partitioning on the PyTorch/CUDA port (repro_torch.core.hypergraph):

1. generate a planted-partition hypergraph (2k vertices / 3k nets — the
   data-placement workload shape: nets = co-access sets),
2. partition it with the multilevel kahypar driver for k ∈ {2, 4, 8},
3. compare the connectivity (λ−1) objective against random assignment and
   round-trip the instance through the hMETIS text format.

    PYTHONPATH=src python examples/hypergraph_partition_torch.py [--cpu]

Runs on the GPU unless ``--cpu`` is given.
"""
import argparse
import os
import tempfile
import time

from repro_torch.core.hypergraph import connectivity, evaluate, kahypar
from repro_torch.core.hypergraph.initial import random_partition
from repro_torch.io import hmetis
from repro_torch.io.generators import planted_hypergraph


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else None

    hg = planted_hypergraph(2048, 3072, blocks=8, seed=0)
    print(f"hypergraph: {hg.n} vertices, {hg.m} nets, {hg.pins} pins")

    for k in (2, 4, 8):
        t0 = time.time()
        part = kahypar(hg, k, eps=0.03, preset="eco", seed=1, device=dev)
        dt = time.time() - t0
        ev = evaluate(hg, part, k)
        rnd = connectivity(hg, random_partition(hg, k, seed=0))
        print(f"k={k}: (λ-1)={ev['km1']} cut-net={ev['cut_net']} "
              f"balance={ev['balance']:.3f} feasible={ev['feasible']} "
              f"| random (λ-1)={rnd} ({rnd / max(ev['km1'], 1):.1f}x worse) "
              f"| {dt:.1f}s")

    # hMETIS round trip — the on-disk interchange format
    path = os.path.join(tempfile.mkdtemp(), "planted.hgr")
    hmetis.write_hmetis(hg, path)
    h2 = hmetis.read_hmetis(path)
    print(f"hMETIS round-trip: {path} "
          f"({h2.m} nets, {h2.n} vertices, checker={h2.check()})")


if __name__ == "__main__":
    main()
