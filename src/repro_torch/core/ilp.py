"""Exact solver and ILP-style improvement (paper §2.10, §4.9).

Gurobi is not available offline, so the *model* construction (the paper's
actual contribution — shrink the instance so an exact solver scales) is kept
and the backend is an exact branch-and-bound with the paper's symmetry
breaking (block ids are interchangeable → a node may only open block
``max_used + 1``; ``overlap`` presets additionally fix seed vertices).

``ilp_exact``  : exact minimum-cut balanced partition of (small) graphs.
``ilp_improve``: extract a local model around high-gain/boundary vertices
(modes boundary|gain|trees), contract the remainder into k fixed terminals,
solve the model exactly, accept if the cut improves (never worse).

Everything here is host numpy; only the kaffpa warm start of ``ilp_exact``
runs on ``device`` (None = CUDA; raises without a card unless
``device="cpu"``).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core.csr import Graph
from repro_torch.core.partition import edge_cut, is_feasible


def _exact_bb(g: Graph, k: int, lmax: float, fixed: Optional[np.ndarray],
              timeout: float = 60.0, ub: float = np.inf):
    """Branch-and-bound exact partitioner.

    fixed[v] = block id or -1 (free).  Returns (best_part, best_cut) or
    (None, ub) if nothing beats ub.  Symmetry breaking: a free node may use
    at most one block beyond those already opened.
    """
    n = g.n
    order = np.argsort(-g.degrees(), kind="stable")  # high degree first
    order = np.concatenate([order[fixed[order] >= 0],
                            order[fixed[order] < 0]]) if fixed is not None \
        else order
    adj = [(g.neighbors(v), g.edge_weights(v)) for v in range(n)]
    part = -np.ones(n, dtype=np.int64)
    sizes = np.zeros(k, dtype=np.int64)
    best = {"cut": ub, "part": None}
    t0 = time.monotonic()

    def rec(idx, cur_cut, max_used):
        if time.monotonic() - t0 > timeout:
            return
        if cur_cut >= best["cut"]:
            return
        if idx == n:
            best["cut"] = cur_cut
            best["part"] = part.copy()
            return
        v = order[idx]
        if fixed is not None and fixed[v] >= 0:
            blocks = [int(fixed[v])]
        else:
            blocks = list(range(min(max_used + 1, k - 1) + 1))
        nbrs, ws = adj[v]
        # try blocks in order of least added cut (best-first)
        added = []
        for b in blocks:
            if sizes[b] + g.vwgt[v] > lmax:
                continue
            delta = int(sum(w for u, w in zip(nbrs, ws)
                            if part[u] >= 0 and part[u] != b))
            added.append((delta, b))
        added.sort()
        for delta, b in added:
            part[v] = b
            sizes[b] += g.vwgt[v]
            rec(idx + 1, cur_cut + delta,
                max(max_used, b))
            sizes[b] -= g.vwgt[v]
            part[v] = -1

    rec(0, 0, -1)
    return best["part"], best["cut"]


def ilp_exact(g: Graph, k: int, eps: float = 0.03, timeout: float = 60.0,
              seed: int = 0, device=None) -> np.ndarray:
    """Exact balanced min-cut partition (use on small graphs / models)."""
    lmax = (1.0 + eps) * np.ceil(g.total_vwgt() / k)
    # warm start with kaffpa for a good upper bound
    from repro_torch.core.kaffpa import kaffpa
    warm = kaffpa(g, k, eps, "fast", seed=seed, device=device)
    ub = edge_cut(g, warm) + 1
    part, cut = _exact_bb(g, k, lmax, None, timeout, ub)
    return part if part is not None else warm


def build_model(g: Graph, part: np.ndarray, k: int,
                mode: str = "boundary", min_gain: int = -1,
                bfs_depth: int = 2, limit_nonzeroes: int = 5_000_000,
                max_free: int = 18) -> tuple:
    """The paper's *model* graph: free vertices (BFS balls around selected
    boundary/gain vertices) + k contracted fixed terminals.

    Returns (model graph, fixed array, free_old_ids).
    """
    src = g.edge_sources()
    boundary = np.unique(src[part[src] != part[g.adjncy]])
    if mode == "gain" and len(boundary):
        # gain of best single move per boundary vertex
        gains = []
        for v in boundary:
            nbrs, ws = g.neighbors(v), g.edge_weights(v)
            own = int(ws[part[nbrs] == part[v]].sum())
            bestx = 0
            for b in np.unique(part[nbrs]):
                if b != part[v]:
                    bestx = max(bestx, int(ws[part[nbrs] == b].sum()))
            gains.append(bestx - own)
        boundary = boundary[np.asarray(gains) >= min_gain]
    sel = set(boundary.tolist())
    frontier = set(boundary.tolist())
    for _ in range(bfs_depth - 1):
        nxt = set()
        for v in frontier:
            nxt.update(g.neighbors(v).tolist())
        nxt -= sel
        sel.update(nxt)
        frontier = nxt
    free = np.asarray(sorted(sel), dtype=np.int64)[:max_free]
    # every block must keep at least one contracted (terminal) node
    freemask = np.isin(np.arange(g.n), free)
    if len(np.unique(part[~freemask])) < k:
        return None, None, np.zeros(0, dtype=np.int64)
    # contract everything else into k terminals
    cl = np.where(freemask,
                  k + np.searchsorted(free, np.arange(g.n)),
                  part)
    from repro_torch.core.coarsen import contract
    model, clmap = contract(g, cl)
    # terminals are the first k coarse ids (cluster ids 0..k-1 sort first)
    fixed = -np.ones(model.n, dtype=np.int64)
    fixed[:k] = np.arange(k)
    return model, fixed, free


def ilp_improve(g: Graph, part: np.ndarray, k: int, eps: float = 0.03,
                mode: str = "boundary", min_gain: int = -1,
                bfs_depth: int = 2, timeout: float = 60.0,
                seed: int = 0) -> np.ndarray:
    """Improve ``part`` by exactly solving the local model (never worse)."""
    part = np.asarray(part, dtype=np.int64)
    model, fixed, free = build_model(g, part, k, mode, min_gain, bfs_depth)
    if model is None or len(free) == 0:
        return part
    lmax = (1.0 + eps) * np.ceil(g.total_vwgt() / k)
    warm_cut = edge_cut(model, np.concatenate(
        [np.arange(k), part[free]]))
    mp, cut = _exact_bb(model, k, lmax, fixed, timeout, warm_cut + 1)
    if mp is None:
        return part
    out = part.copy()
    out[free] = mp[k:]
    if (edge_cut(g, out) <= edge_cut(g, part)
            and is_feasible(g, out, k, eps)):
        return out
    return part
