"""Initial partitioning on the coarsest hypergraph.

Greedy hypergraph growing (GHG): grow block after block from random seeds,
always absorbing the free vertex with the highest attraction to the grown
region, where touching a net for the first time adds its weight to all its
free pins.  The coarsest hypergraph is small by construction, so this runs
host-side; the caller polishes every candidate with the device LP refiner.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hypergraph.container import Hypergraph


def random_partition(hg: Hypergraph, k: int, seed: int = 0) -> np.ndarray:
    """Weight-aware striping after a random shuffle: near-perfect balance."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(hg.n)
    cw = np.cumsum(hg.vwgt[order])
    total = cw[-1] if hg.n else 0
    bounds = total * (np.arange(1, k + 1) / k)
    blk = np.searchsorted(bounds, cw, side="left").clip(0, k - 1)
    part = np.empty(hg.n, dtype=np.int64)
    part[order] = blk
    return part


def greedy_growing(hg: Hypergraph, k: int, seed: int = 0) -> np.ndarray:
    """Greedy hypergraph growing — blocks 0..k-2 grown to the target
    weight, leftovers land in block k-1."""
    rng = np.random.default_rng(seed)
    n = hg.n
    total = hg.total_vwgt()
    part = np.full(n, k - 1, dtype=np.int64)
    free = np.ones(n, dtype=bool)
    for b in range(k - 1):
        target = total * (b + 1) / k - (total - hg.vwgt[free].sum())
        if target <= 0 or not free.any():
            continue
        aff = np.zeros(n)
        touched = np.zeros(hg.m, dtype=bool)
        ids = np.flatnonzero(free)
        cur = int(rng.choice(ids))
        acc = 0
        while True:
            part[cur] = b
            free[cur] = False
            acc += int(hg.vwgt[cur])
            if acc >= target:
                break
            for e in hg.incident_nets(cur):
                if not touched[e]:
                    touched[e] = True
                    aff[hg.net_pins(e)] += hg.ewgt[e]
            aff[cur] = -np.inf
            cand = np.flatnonzero(free)
            if len(cand) == 0:
                break
            best = cand[np.argmax(aff[cand])]
            if aff[best] <= 0:          # region exhausted: random restart
                best = int(rng.choice(cand))
            cur = int(best)
    return part
