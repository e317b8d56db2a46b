"""Hypergraph coarsening: LP clustering over the clique-expansion rating
graph + contraction of both CSR sides.

Clustering reuses the device LP machinery (core/lp.py) on a derived
pairwise-rating graph: r(u, v) = Σ_{e ⊇ {u,v}} w(e) / (|e| − 1) — the
heavy-edge rating the KaHyPar line uses.  Nets above ``max_net_size`` fall
back to a star expansion (hub = first pin, one rating edge per remaining
pin) instead of the full clique: linear cost instead of quadratic, but the
net still contributes clustering signal rather than being skipped outright.

Contraction maps pins through the cluster map, dedups pins within each net,
drops single-pin nets (λ−1 ≡ 0) and merges parallel nets (identical pin
sets) by summing weights — so for any partition constant on clusters both
objectives are preserved exactly.

The clique expansion and the contraction are host numpy with a Python loop
over nets, as in the JAX package; only the LP runs on the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.csr import Graph
from repro_torch.core import lp as lp_mod
from repro_torch.core.multilevel import protect_cut_mask
from repro_torch.core.hypergraph.container import Hypergraph

RATING_SCALE = 16          # fixed-point scale for w(e)/(|e|-1) int ratings


def clique_expansion(hg: Hypergraph, max_net_size: int = 64,
                     scale: int = RATING_SCALE,
                     large_net_fallback: bool = True) -> Graph:
    """Pairwise heavy-edge rating graph (integer weights, ×``scale``).

    Nets with more than ``max_net_size`` pins are star-expanded around
    their first pin (linear #edges) when ``large_net_fallback``; with the
    fallback off they are skipped entirely.
    """
    us, vs, ws = [], [], []
    esz = hg.net_sizes()
    for e in range(hg.m):
        sz = int(esz[e])
        if sz < 2:
            continue
        pins = hg.net_pins(e)
        r = max(1, int(round(scale * int(hg.ewgt[e]) / (sz - 1))))
        if sz > max_net_size:
            if not large_net_fallback:
                continue
            # star fallback: hub = first pin, one edge per remaining pin
            us.append(np.full(sz - 1, pins[0], dtype=np.int64))
            vs.append(pins[1:])
            ws.append(np.full(sz - 1, r, dtype=np.int64))
            continue
        iu, iv = np.triu_indices(sz, k=1)
        us.append(pins[iu]); vs.append(pins[iv])
        ws.append(np.full(len(iu), r, dtype=np.int64))
    if not us:
        return Graph.from_edges(hg.n, [], [], vwgt=hg.vwgt)
    return Graph.from_edges(hg.n, np.concatenate(us), np.concatenate(vs),
                            np.concatenate(ws), vwgt=hg.vwgt, dedup=True)


def star_expansion(hg: Hypergraph) -> Graph:
    """Exact star expansion: one zero-weight auxiliary vertex per net,
    edges (pin, net-vertex) with the net's weight.  Partitioning this graph
    with a graph partitioner is the classical hypergraph baseline; original
    vertices are ids [0, n)."""
    pe = hg.pin_sources()
    u = hg.eind
    v = hg.n + pe
    w = hg.ewgt[pe]
    vwgt = np.concatenate([hg.vwgt, np.zeros(hg.m, dtype=np.int64)])
    return Graph.from_edges(hg.n + hg.m, u, v, w, vwgt=vwgt, dedup=True)


def lp_clustering(hg: Hypergraph, max_cluster_weight: float,
                  iters: int = 8, seed: int = 0,
                  max_net_size: int = 64,
                  protect=None, device=None) -> np.ndarray:
    """Size-constrained LP clustering on the clique-expansion rating, on
    ``device`` (None = CUDA).

    ``protect`` is an optional sequence of partitions whose cuts must not
    be contracted (V-cycle / combine re-coarsening): rating edges crossing
    any protected cut are zeroed so the LP avoids them; the engine's
    signature split removes any residual violation.
    """
    g = clique_expansion(hg, max_net_size=max_net_size)
    if len(g.adjncy) == 0:
        return np.arange(hg.n, dtype=np.int64)
    if protect:
        cross = protect_cut_mask(g.edge_sources(), g.adjncy, protect)
        g = Graph(g.xadj, g.adjncy, g.vwgt,
                  np.where(cross, 0, g.adjwgt).astype(np.int64))
    return lp_mod.size_constrained_lp(g, max_cluster_weight, iters=iters,
                                      seed=seed, device=device)


def contract(hg: Hypergraph, clusters: np.ndarray):
    """Contract clusters; returns (coarse hypergraph, vertex→coarse map)."""
    clusters = np.asarray(clusters, dtype=np.int64)
    uniq, cl = np.unique(clusters, return_inverse=True)
    nc = len(uniq)
    cvw = np.zeros(nc, dtype=np.int64)
    np.add.at(cvw, cl, hg.vwgt)
    # map pins, dedup within each net, drop single-pin nets
    pe = hg.pin_sources()
    cpin = cl[hg.eind]
    order = np.lexsort((cpin, pe))
    pe_s, cp_s = pe[order], cpin[order]
    first = np.ones(len(pe_s), dtype=bool)
    first[1:] = (pe_s[1:] != pe_s[:-1]) | (cp_s[1:] != cp_s[:-1])
    pe_d, cp_d = pe_s[first], cp_s[first]
    # merge parallel nets: canonical key = tuple of sorted coarse pins
    nets: dict = {}
    sizes = np.zeros(hg.m, dtype=np.int64)
    np.add.at(sizes, pe_d, 1)
    starts = np.zeros(hg.m + 1, dtype=np.int64)
    starts[1:] = np.cumsum(sizes)
    for e in range(hg.m):
        s, t = starts[e], starts[e + 1]
        if t - s < 2:
            continue                    # single-pin net vanishes
        key = tuple(cp_d[s:t].tolist())
        w = int(hg.ewgt[e])
        nets[key] = nets.get(key, 0) + w
    pin_lists = [np.asarray(kk, dtype=np.int64) for kk in nets.keys()]
    ewgt = np.asarray(list(nets.values()), dtype=np.int64)
    coarse = Hypergraph.from_nets(nc, pin_lists, ewgt=ewgt, vwgt=cvw,
                                  dedup_pins=False)
    return coarse, cl


def project(labels_coarse: np.ndarray, cl: np.ndarray) -> np.ndarray:
    """Lift a coarse partition back to the finer level."""
    return np.asarray(labels_coarse)[cl]


def coarsen_level(hg: Hypergraph, max_cluster_weight: float, seed: int,
                  iters: int = 8, max_net_size: int = 64,
                  stall_factor: float = 0.95,
                  device=None) -> Optional[tuple]:
    """One coarsening step; returns (coarse, cl) or None if it stalls."""
    clusters = lp_clustering(hg, max_cluster_weight, iters=iters, seed=seed,
                             max_net_size=max_net_size, device=device)
    coarse, cl = contract(hg, clusters)
    if coarse.n >= hg.n * stall_factor:
        return None
    return coarse, cl
