"""Node separators (paper §2.8).

2-way: partition with KaFFPa, then extract the *smallest* separator
obtainable from boundary nodes — a minimum vertex cover of the bipartite
graph of cut edges (Pothen et al. [27]; König: min-VC = max-matching).

k-way: the ``partition_to_vertex_separator`` program — apply the pairwise
construction between all pairs of blocks that share a boundary; the union of
the pairwise separators is a k-way separator.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.csr import Graph
from repro_torch.core.kaffpa import kaffpa


def _bipartite_min_vertex_cover(left: np.ndarray, right: np.ndarray,
                                edges: list) -> Tuple[set, set]:
    """König construction. ``edges``: list of (li, ri) index pairs into
    left/right.  Returns (cover_left_idx, cover_right_idx)."""
    nl, nr = len(left), len(right)
    adj = [[] for _ in range(nl)]
    for (li, ri) in edges:
        adj[li].append(ri)
    match_l = -np.ones(nl, dtype=np.int64)
    match_r = -np.ones(nr, dtype=np.int64)

    def try_kuhn(u, seen):
        for v in adj[u]:
            if not seen[v]:
                seen[v] = True
                if match_r[v] < 0 or try_kuhn(match_r[v], seen):
                    match_l[u] = v
                    match_r[v] = u
                    return True
        return False

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(10000, nl + nr + 100))
    try:
        for u in range(nl):
            try_kuhn(u, np.zeros(nr, dtype=bool))
    finally:
        sys.setrecursionlimit(old)

    # König: Z = unmatched-L ∪ reachable via alternating paths
    visited_l = match_l < 0
    visited_r = np.zeros(nr, dtype=bool)
    queue = list(np.flatnonzero(visited_l))
    while queue:
        u = queue.pop()
        for v in adj[u]:
            if not visited_r[v]:
                visited_r[v] = True
                w = match_r[v]
                if w >= 0 and not visited_l[w]:
                    visited_l[w] = True
                    queue.append(int(w))
    cover_l = set(np.flatnonzero(~visited_l).tolist())
    cover_r = set(np.flatnonzero(visited_r).tolist())
    return cover_l, cover_r


def separator_from_partition_pair(g: Graph, part: np.ndarray, a: int,
                                  b: int) -> np.ndarray:
    """Minimum boundary-vertex-cover separator for the (a, b) cut."""
    src = g.edge_sources()
    cut = (part[src] == a) & (part[g.adjncy] == b)
    if not cut.any():
        return np.zeros(0, dtype=np.int64)
    u = src[cut]
    v = g.adjncy[cut]
    left, linv = np.unique(u, return_inverse=True)
    right, rinv = np.unique(v, return_inverse=True)
    cov_l, cov_r = _bipartite_min_vertex_cover(
        left, right, list(zip(linv.tolist(), rinv.tolist())))
    return np.concatenate([left[sorted(cov_l)], right[sorted(cov_r)]])


def partition_to_vertex_separator(g: Graph, part: np.ndarray,
                                  k: int) -> np.ndarray:
    """The ``partition_to_vertex_separator`` program (k > 2)."""
    seps = []
    src = g.edge_sources()
    for a in range(k):
        for b in range(a + 1, k):
            if np.any((part[src] == a) & (part[g.adjncy] == b)):
                seps.append(separator_from_partition_pair(g, part, a, b))
    if not seps:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(seps))


def node_separator(g: Graph, eps: float = 0.20, preset: str = "strong",
                   seed: int = 0, part: np.ndarray = None,
                   device=None) -> tuple:
    """The ``node_separator`` program (2-way, §4.4.2), the post-hoc
    construction; without ``part`` it partitions with kaffpa on ``device``
    (None = CUDA).

    Returns (separator_ids, part2) where part2 is the underlying bipartition.
    """
    if part is None:
        part = kaffpa(g, 2, eps, preset, seed=seed, device=device)
    sep = partition_to_vertex_separator(g, part, 2)
    # trivial fallback: smaller boundary side (the paper's baseline §2.8)
    src = g.edge_sources()
    cutedge = part[src] != part[g.adjncy]
    b0 = np.unique(src[cutedge & (part[src] == 0)])
    b1 = np.unique(src[cutedge & (part[src] == 1)])
    trivial = b0 if len(b0) <= len(b1) else b1
    if len(trivial) and (len(sep) == 0 or len(trivial) < len(sep)):
        sep = trivial
    return sep, part


def verify_separator(g: Graph, part: np.ndarray, sep: np.ndarray,
                     k: int) -> bool:
    """No edge may run between distinct blocks once S is removed, AND
    removing S must actually disconnect the blocks: no connected component
    of G − S may contain vertices of two distinct blocks.  The component
    sweep asserts the disconnection property directly; it is implied by the
    edge check (a mixed component must contain a cross-block edge), so it
    is belt-and-braces — a second, independent implementation of the
    guarantee rather than a stronger one.

    Components are labelled by their minimum vertex id, found by min-label
    propagation with pointer jumping (comp[v] ← comp[comp[v]] after each
    sweep), so a 1M-vertex mesh takes a few sweeps, not its diameter."""
    part = np.asarray(part, dtype=np.int64)
    in_sep = np.zeros(g.n, dtype=bool)
    in_sep[np.asarray(sep, dtype=np.int64)] = True
    src = g.edge_sources()
    ok = in_sep[src] | in_sep[g.adjncy] | (part[src] == part[g.adjncy])
    if not np.all(ok):
        return False
    comp = np.where(in_sep, -1, np.arange(g.n))
    alive = ~in_sep[src] & ~in_sep[g.adjncy]
    u, v = src[alive], g.adjncy[alive]
    rest = ~in_sep
    while True:
        nxt = comp.copy()
        np.minimum.at(nxt, u, comp[v])
        while True:          # comp[v] <= v always, so jumps stay in place
            jump = nxt.copy()
            jump[rest] = nxt[nxt[rest]]
            if np.array_equal(jump, nxt):
                break
            nxt = jump
        if np.array_equal(nxt, comp):
            break
        comp = nxt
    # one block per component: as many (component, block) pairs as blocks
    pairs = np.unique(np.stack([comp[rest], part[rest]]), axis=1)
    return pairs.shape[1] == len(np.unique(comp[rest]))
