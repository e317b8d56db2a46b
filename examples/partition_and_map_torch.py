"""Process mapping end to end on the PyTorch/CUDA port (paper §2.6):

1. partition an application graph into k = prod(hierarchy) blocks,
2. map blocks onto the hierarchical machine (global multisection + swaps),
3. map a training step's per-axis collective traffic onto a machine
   hierarchy — which mesh axis goes on which level.

    PYTHONPATH=src python examples/partition_and_map_torch.py [--cpu]

Runs on the GPU unless ``--cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.core.mapping import (kaffpa_with_mapping, process_mapping,
                                      processor_distance_matrix, qap_cost)
from repro_torch.io.generators import random_geometric
from repro_torch.launch.topology import choose_axis_assignment


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else None

    # --- application graph → hierarchical machine (4 cores × 4 chips × 2)
    g = random_geometric(2048, seed=1)
    part, mapping, qap = kaffpa_with_mapping(g, "4:4:2", "1:10:100",
                                             eps=0.03, preset="eco", seed=1,
                                             device=dev)
    print(f"kaffpa --enable_mapping: QAP cost {qap}")

    # --- synthetic comm matrix: ring-heavy
    k = 32
    comm = np.zeros((k, k), dtype=np.int64)
    for p in range(k):
        comm[p, (p + 1) % k] = comm[(p + 1) % k, p] = 200
    mapping = process_mapping(comm, "4:4:2", "1:10:100", seed=0, device=dev)
    dist = processor_distance_matrix([4, 4, 2], [1, 10, 100])
    print(f"ring pattern: mapped QAP {qap_cost(comm, dist, mapping)} "
          f"vs identity {qap_cost(comm, dist, np.arange(k))}")

    # --- which mesh axis goes on which hardware level?  Per-axis
    # collective bytes of a data- and tensor-parallel train step (example
    # values: the data axis's gradient all-reduce dominates)
    axis_bytes = {"data": 4.1e9, "model": 0.9e9, "pod": 0.4e9}
    axis_sizes = {"data": 16, "model": 16, "pod": 2}
    out = choose_axis_assignment(axis_bytes, axis_sizes,
                                 hierarchy=(16, 16, 2),
                                 distances=(1, 10, 100), seed=0, device=dev)
    print(f"mesh-axis mapping: QAP {out['qap']} vs identity "
          f"{out['identity_qap']} (improvement {out['improvement']:.1%})")


if __name__ == "__main__":
    main()
