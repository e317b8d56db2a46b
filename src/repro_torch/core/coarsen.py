"""Coarsening: graph contraction + the two cluster sources KaFFPa uses
(heavy-edge matching for mesh-like graphs, size-constrained LP clustering for
social graphs — paper §2.1/§2.4).

The level loop / contraction bookkeeping is host-side numpy (irregular), the
LP inner loop runs on the device (core/lp.py).  ``forbidden`` edge masks
implement the KaFFPaE combine operator's invariant: cut edges of the parent
partitions are never contracted (§2.2).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.csr import Graph
from repro_torch.core import lp as lp_mod


def contract(g: Graph, clusters: np.ndarray):
    """Contract clusters; returns (coarse graph, cluster->coarse-id map).

    Coarse node weight = sum of member weights; coarse edge weight = sum of
    inter-cluster edge weights; intra-cluster edges vanish.
    """
    clusters = np.asarray(clusters, dtype=np.int64)
    uniq, cl = np.unique(clusters, return_inverse=True)
    nc = len(uniq)
    cvw = np.zeros(nc, dtype=np.int64)
    np.add.at(cvw, cl, g.vwgt)
    src = g.edge_sources()
    cu, cv = cl[src], cl[g.adjncy]
    keep = cu < cv                       # each undirected inter-cluster edge once
    coarse = Graph.from_edges(nc, cu[keep], cv[keep], g.adjwgt[keep],
                              vwgt=cvw, dedup=True)
    return coarse, cl


def project(labels_coarse: np.ndarray, cl: np.ndarray) -> np.ndarray:
    """Lift a coarse partition back to the finer level."""
    return np.asarray(labels_coarse)[cl]


def heavy_edge_matching(g: Graph, seed: int = 0, rounds: int = 3,
                        max_cluster_weight: Optional[float] = None,
                        forbidden: Optional[np.ndarray] = None) -> np.ndarray:
    """Randomized parallel HEM: mutual heaviest-neighbour proposals match.

    Returns cluster ids (matched pairs share an id).  ``forbidden`` is a
    boolean mask over directed edges (aligned with adjncy) that must not be
    contracted.
    """
    rng = np.random.default_rng(seed)
    n = g.n
    match = -np.ones(n, dtype=np.int64)
    src = g.edge_sources()
    w = g.adjwgt.astype(np.float64)
    if forbidden is not None:
        w = np.where(forbidden, -np.inf, w)
    for _ in range(rounds):
        free = match < 0
        # candidate edges: both endpoints free, weight-eligible
        ok = free[src] & free[g.adjncy]
        if max_cluster_weight is not None:
            ok &= (g.vwgt[src] + g.vwgt[g.adjncy]) <= max_cluster_weight
        wr = np.where(ok, w + rng.random(len(w)), -np.inf)
        if not np.any(np.isfinite(wr)):
            break
        # per-node best proposal (segment argmax over CSR rows)
        prop = -np.ones(n, dtype=np.int64)
        best = np.full(n, -np.inf)
        np.maximum.at(best, src, wr)
        is_best = wr >= best[src] - 1e-12
        cand = np.where(is_best & np.isfinite(wr), g.adjncy, -1)
        np.maximum.at(prop, src, cand)
        # mutual?
        has = prop >= 0
        mutual = has & (prop[np.clip(prop, 0, n - 1)] == np.arange(n))
        a = np.flatnonzero(mutual)
        b = prop[a]
        lo = np.minimum(a, b)
        match[a] = lo
    clusters = np.where(match >= 0, match, np.arange(n))
    return clusters


def lp_clustering(g: Graph, max_cluster_weight: float, iters: int = 8,
                  seed: int = 0,
                  forbidden: Optional[np.ndarray] = None,
                  device=None) -> np.ndarray:
    """Size-constrained LP clustering (social coarsening, §2.4) on
    ``device`` (None = CUDA).

    ``forbidden`` directed-edge mask: those edges' weights are zeroed for the
    clustering and any residual violation is split apart afterwards, so no
    forbidden edge is ever contracted.
    """
    if forbidden is None:
        clusters = lp_mod.size_constrained_lp(g, max_cluster_weight,
                                              iters=iters, seed=seed,
                                              device=device)
    else:
        g2 = Graph(g.xadj, g.adjncy, g.vwgt,
                   np.where(forbidden, 0, g.adjwgt).astype(np.int64))
        # w=0 edges contribute nothing; the LP may still merge endpoints via
        # other paths — split violators below.
        clusters = lp_mod.size_constrained_lp(g2, max_cluster_weight,
                                              iters=iters, seed=seed,
                                              device=device)
        src = g.edge_sources()
        bad = forbidden & (clusters[src] == clusters[g.adjncy])
        viol = np.unique(src[bad])
        # detach violating endpoints into singletons (stable: pick src side)
        clusters = clusters.copy()
        clusters[viol] = g.n + np.arange(len(viol))
    return clusters


def coarsen_level(g: Graph, mode: str, max_cluster_weight: float,
                  seed: int, forbidden: Optional[np.ndarray] = None,
                  device=None):
    """One coarsening step; returns (coarse, cl) or None if it stalls.
    ``"lp"`` clusters on ``device`` (None = CUDA); ``"matching"`` is host
    code and ignores it."""
    if mode == "matching":
        clusters = heavy_edge_matching(g, seed=seed,
                                       max_cluster_weight=max_cluster_weight,
                                       forbidden=forbidden)
    elif mode == "lp":
        clusters = lp_clustering(g, max_cluster_weight, seed=seed,
                                 forbidden=forbidden, device=device)
    else:
        raise ValueError(f"unknown coarsening mode {mode!r}")
    coarse, cl = contract(g, clusters)
    if coarse.n >= g.n * 0.95:          # stalled — not shrinking
        return None
    return coarse, cl
