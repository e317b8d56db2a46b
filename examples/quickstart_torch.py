"""Quickstart on the PyTorch/CUDA port: partition a graph with every major
KaHIP entry point, write and read the file formats, and record a run.

    PYTHONPATH=src python examples/quickstart_torch.py [--cpu] [--out DIR]

Runs on the GPU unless ``--cpu`` is given.  Writes the Metis graph, its
ParHIP binary form (both converters), the partition files and a Chrome
trace of a recorded kaffpa into ``--out`` (a new temporary directory by
default); open the trace in https://ui.perfetto.dev.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch import obs
from repro_torch.core import interface as api
from repro_torch.core.edgepart import edge_partition
from repro_torch.core.kabape import kabape_refine
from repro_torch.core.kaffpa import kaffpa
from repro_torch.core.partition import edge_partition_metrics, evaluate
from repro_torch.core.separator import node_separator
from repro_torch.io import binio
from repro_torch.io.generators import barabasi_albert, grid2d
from repro_torch.io.metis import (graphchecker, read_partition, write_metis,
                                  write_partition)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else None
    out = args.out or tempfile.mkdtemp(prefix="quickstart_torch_")
    os.makedirs(out, exist_ok=True)

    g = grid2d(32, 32)
    print(f"mesh graph: n={g.n} m={g.m}")

    # --- kaffpa presets (paper §4.1)
    for preset in ("fast", "eco", "strong"):
        part = kaffpa(g, 4, eps=0.03, preset=preset, seed=1, device=dev)
        print(f"kaffpa --preconfiguration={preset:7s}:",
              evaluate(g, part, 4))

    # --- perfectly balanced (KaBaPE, §2.3)
    part0 = kaffpa(g, 4, 0.03, "fast", seed=1, device=dev)
    part_b = kabape_refine(g, part0, 4, eps=0.0, device=dev)
    print("kabape eps=0:", evaluate(g, part_b, 4, eps=0.0))

    # --- social preset on a scale-free graph (§2.4)
    b = barabasi_albert(2048, 4, seed=1)
    part_s = kaffpa(b, 8, 0.03, "fastsocial", seed=1, device=dev)
    print("kaffpa fastsocial on BA graph:", evaluate(b, part_s, 8))

    # --- node separator (§2.8)
    sep, _ = node_separator(g, eps=0.2, preset="fast", seed=1, device=dev)
    print(f"2-way node separator: {len(sep)} vertices")

    # --- edge partition (§2.7)
    ep = edge_partition(g, 4, preset="fast", seed=1, device=dev)
    print("SPAC edge partition:", edge_partition_metrics(g, ep, 4))

    # --- file formats + checker (§3): Metis text, ParHIP binary, partitions
    text = os.path.join(out, "quickstart.graph")
    write_metis(g, text)
    assert graphchecker(text) == []
    binio.graph2binary(text, os.path.join(out, "quickstart.bin"))
    binio.graph2binary_external(text, os.path.join(out, "quickstart.ext.bin"))
    with open(os.path.join(out, "quickstart.bin"), "rb") as f1, \
            open(os.path.join(out, "quickstart.ext.bin"), "rb") as f2:
        assert f1.read() == f2.read()
    back = binio.read_binary(os.path.join(out, "quickstart.bin"))
    assert np.array_equal(back.adjncy, g.adjncy)
    write_partition(part0, os.path.join(out, "tmppartition4"))
    binio.write_partition_binary(part0, os.path.join(out, "tmppartition4.bin"))
    assert np.array_equal(read_partition(os.path.join(out, "tmppartition4")),
                          binio.read_partition_binary(
                              os.path.join(out, "tmppartition4.bin")))
    print(f"wrote {out}/quickstart.graph, its binary form (both converters) "
          f"and tmppartition4 (text and binary)")

    # --- the C-style library interface (§5)
    cut, part = api.kaffpa(g.n, None, g.xadj, None, g.adjncy, nparts=2,
                           imbalance=0.03, seed=0, mode=api.ECO, device=dev)
    print(f"library kaffpa(k=2): edgecut={cut}")

    # --- observability: spans, counters, trajectories, a Chrome trace
    rec = obs.Recorder("quickstart")
    cut, part = api.kaffpa(g.n, None, g.xadj, None, g.adjncy, nparts=4,
                           imbalance=0.03, seed=0, mode=api.ECO, report=rec,
                           device=dev)
    launches = rec.counters().get("kernels/lp_affinity/launches", 0)
    print(f"recorded run: edgecut={cut} kernel builds={rec.compile_count} "
          f"lp_affinity launches={int(launches)} "
          f"cycles={rec.trajectory('cycles')}")
    trace = os.path.join(out, "quickstart_trace.json")
    n = obs.write_chrome_trace(rec, trace)
    print(f"wrote {trace} ({n} events; open in https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
