"""Initial partitioning on the coarsest graph (paper §2.1).

KaHIP's initial partitioner is recursive bisection with region growing +
refinement.  The coarsest graph is small by construction, so this runs
host-side (numpy BFS); every bisection is polished by the device gain
refinement (core/refine.py) through the caller.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import Graph
from repro_torch.core.partition import edge_cut


def bfs_grow_bisection(g: Graph, target_frac: float, seed: int = 0,
                       tries: int = 4) -> np.ndarray:
    """Greedy graph growing: BFS from a random seed until the visited set
    reaches ``target_frac`` of the total node weight; best cut of ``tries``.
    """
    rng = np.random.default_rng(seed)
    total = g.total_vwgt()
    target = target_frac * total
    best_part, best_cut = None, np.inf
    n = g.n
    for t in range(tries):
        start = int(rng.integers(0, n))
        visited = np.zeros(n, dtype=bool)
        frontier = [start]
        visited[start] = True
        acc = int(g.vwgt[start])
        # BFS with greedy frontier ordering (prefer high connectivity to the
        # grown region == low expected cut)
        while acc < target and frontier:
            nxt = []
            for v in frontier:
                for u in g.neighbors(v):
                    if not visited[u]:
                        visited[u] = True
                        nxt.append(int(u))
                        acc += int(g.vwgt[u])
                        if acc >= target:
                            break
                if acc >= target:
                    break
            frontier = nxt
            if not frontier and acc < target:
                rest = np.flatnonzero(~visited)
                if len(rest) == 0:
                    break
                s2 = int(rng.choice(rest))
                visited[s2] = True
                frontier = [s2]
                acc += int(g.vwgt[s2])
        part = (~visited).astype(np.int64)    # grown region = block 0
        cut = edge_cut(g, part)
        if cut < best_cut:
            best_cut, best_part = cut, part
    return best_part


def random_partition(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # weight-aware striping after a random shuffle: near-perfect balance
    order = rng.permutation(g.n)
    cw = np.cumsum(g.vwgt[order])
    total = cw[-1] if g.n else 0
    bounds = total * (np.arange(1, k + 1) / k)
    blk = np.searchsorted(bounds, cw, side="left").clip(0, k - 1)
    part = np.empty(g.n, dtype=np.int64)
    part[order] = blk
    return part


def recursive_bisection(g: Graph, k: int, seed: int = 0,
                        refine_fn=None) -> np.ndarray:
    """k-way via recursive bisection; ``refine_fn(g, part, k, frac)`` may
    polish each 2-way split (device refinement plugged in by kaffpa)."""
    part = np.zeros(g.n, dtype=np.int64)
    _rb(g, np.arange(g.n), k, 0, part, seed, refine_fn)
    return part


def _rb(g: Graph, ids: np.ndarray, k: int, offset: int, out: np.ndarray,
        seed: int, refine_fn) -> None:
    if k == 1 or g.n == 0:
        out[ids] = offset
        return
    k1 = k // 2
    frac = k1 / k
    frac0 = 1.0 - frac                  # weight fraction of block 0 (k-k1 parts)
    two = bfs_grow_bisection(g, frac0, seed=seed)
    if refine_fn is not None:
        two = refine_fn(g, two, frac0)  # polish the 2-way split on device
    m0 = two == 0
    sub0, ids0 = g.subgraph(m0)
    sub1, ids1 = g.subgraph(~m0)
    _rb(sub0, ids[ids0], k - k1, offset, out, seed * 2 + 1, refine_fn)
    _rb(sub1, ids[ids1], k1, offset + (k - k1), out, seed * 2 + 2, refine_fn)
