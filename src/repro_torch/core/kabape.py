"""KaBaPE — strictly balanced refinement via negative cycles (paper §2.3).

The balance constraint is relaxed per *move* but maintained globally by
combining moves: build the directed *block-gain graph* where arc (a → b)
carries cost = −(best single-node gain of moving some node from block a to
block b).  A negative-cost cycle is a set of moves that strictly decreases
the cut while every block's weight is unchanged (each block on the cycle
loses and gains one node) — for unit node weights exactly, for weighted
nodes up to a feasibility check.  Efficient negative-cycle detection =
Bellman–Ford on k nodes (k is small).

The *balancing* variant finds a min-cost path from an overloaded block to an
underloaded one — this is what lets KaBaPE guarantee feasible output where
Metis/Scotch/Jostle cannot (§2.3).

The gain matrix is the only device work: the (n, k) affinities come from
the level's ELL through ``ops.lp_affinity`` (the CUDA kernel on a card)
or, without an ELL, from the COO scatter, and are reduced to the (k, k)
best gains and nodes where they lie, so only that pair crosses to the
host.  Every search below takes the caller's cached views: a memetic run
hands over its medium's level-0 views, so no call rebuilds them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.csr import CooGraph, EllGraph, Graph
from repro_torch.core import lp as lp_mod
from repro_torch.core import refine as R
from repro_torch.core.partition import edge_cut, block_weights, is_feasible
from repro_torch.kernels import ops


def _views(g: Graph, coo: Optional[CooGraph], ell: Optional[EllGraph],
           device):
    """The caller's views (``ell`` None: the COO route), else views built
    once on ``device`` (None = CUDA), the ELL only where the kernel runs."""
    if coo is None:
        return R._views(g, None, ell, None, device)
    return coo, ell


def _gain_matrix(g: Graph, part: np.ndarray, k: int,
                 coo: Optional[CooGraph] = None,
                 ell: Optional[EllGraph] = None, device=None):
    """best_gain[a, b], best_node[a, b]: best single-node move a→b.

    Ties go to the lowest vertex id of block a (``np.argmax``'s rule);
    best_node[a, a] is block a's lowest id and best_gain[a, a] = -inf.
    The affinities take the ELL through ``ops.lp_affinity`` when ``ell``
    is given, else the COO scatter; both are exact integer sums."""
    coo, ell = _views(g, coo, ell, device)
    view = ell if ell is not None else coo
    dev = view.vwgt.device
    n = g.n
    part_t = torch.from_numpy(np.asarray(part, dtype=np.int64)).to(dev)
    lab = torch.zeros(1, view.n_pad, dtype=torch.int32, device=dev)
    lab[0, :n] = part_t.int()
    if ell is not None:
        aff = ops.lp_affinity(ell.nbr, ell.wgt, lab, k)[0, :n]
    else:
        aff = lp_mod.kway_affinity_coo(coo, lab, k)[0, :n]
    gain = aff - aff.gather(1, part_t[:, None])             # (n, k)
    key = (part_t[:, None] * k
           + torch.arange(k, device=dev)[None, :]).reshape(-1)
    gain = gain.reshape(-1)
    best = torch.full((k * k,), -np.inf, device=dev).scatter_reduce(
        0, key, gain, "amax")
    ids = torch.arange(n, device=dev)[:, None].expand(n, k).reshape(-1)
    node = torch.full((k * k,), n, dtype=torch.int64, device=dev)
    node = node.scatter_reduce(0, key, torch.where(gain == best[key], ids, n),
                               "amin")
    both = torch.cat([best.double(), node.double()]).cpu().numpy()
    best_gain = both[:k * k].reshape(k, k).copy()
    best_node = both[k * k:].astype(np.int64).reshape(k, k)
    best_node[best_node == n] = -1                          # empty block
    best_gain[np.arange(k), np.arange(k)] = -np.inf
    return best_gain, best_node


def _bellman_ford_negative_cycle(cost: np.ndarray) -> Optional[list]:
    """Return a negative cycle (list of node ids) in the dense digraph, or
    None.  cost[a, b] = arc cost (np.inf = absent)."""
    k = cost.shape[0]
    dist = np.zeros(k)
    pred = -np.ones(k, dtype=np.int64)
    x = -1
    for _ in range(k):
        x = -1
        for a in range(k):
            for b in range(k):
                if np.isfinite(cost[a, b]) and dist[a] + cost[a, b] < dist[b] - 1e-9:
                    dist[b] = dist[a] + cost[a, b]
                    pred[b] = a
                    x = b
        if x < 0:
            return None
    # x is on or reachable from a negative cycle; walk back k steps
    for _ in range(k):
        x = pred[x]
    cyc = [x]
    v = pred[x]
    while v != x:
        cyc.append(v)
        v = pred[v]
    cyc.reverse()
    return cyc


def negative_cycle_refine(g: Graph, part: np.ndarray, k: int, eps: float,
                          max_iters: int = 50,
                          coo: Optional[CooGraph] = None,
                          ell: Optional[EllGraph] = None,
                          device=None) -> np.ndarray:
    """Apply negative-cycle move combinations until none remain."""
    part = np.asarray(part, dtype=np.int64).copy()
    coo, ell = _views(g, coo, ell, device)
    total = g.total_vwgt()
    lmax = (1.0 + eps) * np.ceil(total / k)
    for _ in range(max_iters):
        bg, bn = _gain_matrix(g, part, k, coo, ell)
        cost = np.where(np.isfinite(bg), -bg, np.inf)
        # arcs with no movable node are absent
        cyc = _bellman_ford_negative_cycle(cost)
        if cyc is None:
            return part
        cand = part.copy()
        for i, a in enumerate(cyc):
            b = cyc[(i + 1) % len(cyc)]
            v = bn[a, b]
            if v < 0:
                break
            cand[v] = b
        else:
            bw = block_weights(g, cand, k)
            if (bw.max() <= lmax + 1e-9
                    and edge_cut(g, cand) < edge_cut(g, part)):
                part = cand
                continue
        return part
    return part


def balance_path(g: Graph, part: np.ndarray, k: int, eps: float,
                 max_iters: int = 200, coo: Optional[CooGraph] = None,
                 ell: Optional[EllGraph] = None,
                 device=None) -> np.ndarray:
    """Make an infeasible partition feasible via min-cost gain paths from
    overloaded to underloaded blocks (the KaBaPE balancing variant).  Each
    iteration moves one vertex per arc of the path."""
    part = np.asarray(part, dtype=np.int64).copy()
    coo, ell = _views(g, coo, ell, device)
    total = g.total_vwgt()
    lmax = np.ceil((1.0 + eps) * np.ceil(total / k))
    for _ in range(max_iters):
        bw = block_weights(g, part, k)
        over = np.flatnonzero(bw > lmax)
        if len(over) == 0:
            return part
        a0 = int(over[np.argmax(bw[over])])
        bg, bn = _gain_matrix(g, part, k, coo, ell)
        cost = np.where(np.isfinite(bg), -bg, np.inf)
        # hop-bounded DP (≤ k arcs): costs are negative (gains), so plain
        # Bellman-Ford pred-chains may loop — the hop index makes it a DAG.
        dp = np.full((k + 1, k), np.inf)
        pred = -np.ones((k + 1, k), dtype=np.int64)
        dp[0, a0] = 0.0
        for h in range(1, k + 1):
            dp[h] = dp[h - 1]
            pred[h] = -1
            for a in range(k):
                if not np.isfinite(dp[h - 1, a]):
                    continue
                for b in range(k):
                    if np.isfinite(cost[a, b]) and dp[h - 1, a] + cost[a, b] < dp[h, b] - 1e-12:
                        dp[h, b] = dp[h - 1, a] + cost[a, b]
                        pred[h, b] = a
        under = np.flatnonzero(bw < lmax)
        cand = [(dp[h, b], h, b) for h in range(1, k + 1) for b in under
                if np.isfinite(dp[h, b]) and pred[h, b] >= 0]
        if not cand:
            return part  # cannot balance further
        _, h0, b0 = min(cand)
        # reconstruct hop-indexed path a0 → ... → b0 and apply the moves
        path = [b0]
        h, v = h0, b0
        while h > 0:
            if pred[h, v] >= 0:
                v = int(pred[h, v])
                path.append(v)
            h -= 1                      # pred == -1 ⇒ dp copied from h-1
        path.reverse()
        if len(set(path)) != len(path) or path[0] != a0:
            # the DP found a *walk* through a negative cycle — fall back to
            # the direct arc a0 → cheapest underloaded block (always simple,
            # guaranteed progress)
            direct = [u for u in under if np.isfinite(cost[a0, u])]
            if not direct:
                return part
            b0 = int(min(direct, key=lambda u: cost[a0, u]))
            path = [a0, b0]
        for i in range(len(path) - 1):
            a, b = path[i], path[i + 1]
            node = bn[a, b]
            if node >= 0:
                part[node] = b
    return part


def kabapeE(g: Graph, k: int, eps: float = 0.03, preset: str = "fast",
            n_islands: int = 4, population: int = 4,
            time_limit: float = 10.0, seed: int = 0,
            internal_bal: float = 0.01, **kwargs) -> np.ndarray:
    """The memetic KaBaPE program: the same island driver as ``kaffpaE``
    (core/memetic) with the negative-cycle polish on every child and the
    balanced replacement rule (infeasible members are evicted first), so
    the archipelago converges to strictly balanced partitions."""
    from repro_torch.core.evolve import kaffpaE
    return kaffpaE(g, k, eps, preset, n_islands=n_islands,
                   population=population, time_limit=time_limit, seed=seed,
                   enable_kabape=True, kabaE_internal_bal=internal_bal,
                   **kwargs)


def kabape_refine(g: Graph, part: np.ndarray, k: int, eps: float = 0.0,
                  internal_bal: float = 0.01, rounds: int = 3,
                  seed: int = 0, coo: Optional[CooGraph] = None,
                  ell: Optional[EllGraph] = None,
                  device=None) -> np.ndarray:
    """Full KaBaPE polish: relax to ``internal_bal``, explore, re-balance,
    then eliminate negative cycles at the strict constraint.

    ``coo``/``ell`` are the graph's cached views (a memetic run passes its
    medium's); without them the views are built once here on ``device``
    (None = CUDA), the ELL only where the kernel runs."""
    part = np.asarray(part, dtype=np.int64)
    coo, ell = _views(g, coo, ell, device)
    for r in range(rounds):
        # relaxed local search (larger neighbourhood, §2.3)
        part = R.refine_kway(g, part, k, eps + internal_bal,
                             rounds=8, seed=seed + r, coo=coo, ell=ell,
                             use_kernel=ell is not None)
        part = balance_path(g, part, k, eps, coo=coo, ell=ell)
        part = negative_cycle_refine(g, part, k, eps, coo=coo, ell=ell)
        if is_feasible(g, part, k, eps):
            break
    if not is_feasible(g, part, k, eps):
        part = balance_path(g, part, k, eps, max_iters=500, coo=coo, ell=ell)
    return part
