"""Node ordering for fill-in minimization (paper §2.9, §4.7).

``reduced_nd``: apply data-reduction rules exhaustively, then nested
dissection on the kernel; ``fast_reduced_nd`` uses the fast preset and fewer
ND levels.  Dissection separators come from the multilevel node-separator
engine (core/nodesep) on a device (None = CUDA), which optimizes separator
weight directly at every hierarchy level; the post-hoc two-step
construction (core/separator.py) remains available as the baseline.
Reduction numbers follow §4.7:

  0 simplicial node reduction (neighbourhood is a clique → eliminate first)
  1 indistinguishable nodes   (same closed neighbourhood → merge)
  2 twins                     (same open neighbourhood → merge)
  3 path compression          (chains of degree-2 nodes)
  4 degree-2 elimination
  5 triangle contraction

Simplicial detection is exact for degree ≤ 2 and clique-sampled above (the
full check is quadratic in degree); merged/eliminated nodes are re-inserted
into the ordering in reverse reduction order, which preserves fill quality.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import Graph, resolve_device
from repro_torch.core.nodesep import multilevel_node_separator


def _neighbor_sets(g: Graph):
    return [frozenset(g.neighbors(v).tolist()) for v in range(g.n)]


def _is_clique(g: Graph, nodes: np.ndarray, nbr_sets) -> bool:
    nodes = list(nodes)
    for i, u in enumerate(nodes):
        s = nbr_sets[u]
        for v in nodes[i + 1:]:
            if v not in s:
                return False
    return True


def apply_reductions(g: Graph, order_spec=(0, 1, 2, 3, 4),
                     max_clique_check: int = 8, max_passes: int = 30):
    """Exhaustive reduction on a dynamic elimination graph.

    Every elimination updates the quotient graph the way symbolic Cholesky
    would (degree-2 elimination adds the implied neighbour edge; simplicial
    elimination adds none), so the kernel is the true reduced instance.

    Returns (kernel graph, kernel_old_ids, prefix, follow):
      prefix — nodes safely eliminated *before* the kernel ordering;
      follow — representative → merged twins, re-inserted right after their
               representative (zero extra fill beyond the rep's clique).
    """
    n = g.n
    adj = [set(g.neighbors(v).tolist()) for v in range(n)]
    alive = np.ones(n, dtype=bool)
    prefix: list = []
    follow: dict = {}

    def eliminate(v, add_clique: bool):
        alive[v] = False
        nbrs = [u for u in adj[v] if alive[u]]
        for u in nbrs:
            adj[u].discard(v)
        if add_clique:
            for i, a in enumerate(nbrs):
                for b in nbrs[i + 1:]:
                    adj[a].add(b)
                    adj[b].add(a)

    for _ in range(max_passes):
        changed = False
        for rule in order_spec:
            if rule == 0:       # simplicial (exact up to max_clique_check)
                for v in range(n):
                    if not alive[v] or len(adj[v]) > max_clique_check:
                        continue
                    nbrs = list(adj[v])
                    if len(nbrs) <= 1 or all(
                            b in adj[a] for i, a in enumerate(nbrs)
                            for b in nbrs[i + 1:]):
                        prefix.append(v)
                        eliminate(v, add_clique=False)
                        changed = True
            elif rule in (1, 2):    # indistinguishable / twins
                buckets: dict = {}
                for v in range(n):
                    if not alive[v]:
                        continue
                    key = frozenset(adj[v] | {v}) if rule == 1 \
                        else frozenset(adj[v])
                    buckets.setdefault(key, []).append(v)
                for vs in buckets.values():
                    if len(vs) > 1:
                        rep = vs[0]
                        for v in vs[1:]:
                            follow.setdefault(rep, []).append(v)
                            eliminate(v, add_clique=False)
                            changed = True
            elif rule in (3, 4):    # degree-2 / path compression
                for v in range(n):
                    if not alive[v] or len(adj[v]) != 2:
                        continue
                    prefix.append(v)
                    eliminate(v, add_clique=True)   # connect the two nbrs
                    changed = True
            elif rule == 5:     # triangle tip (simplicial deg-2) contraction
                for v in range(n):
                    if not alive[v] or len(adj[v]) != 2:
                        continue
                    a, b = sorted(adj[v])
                    if b in adj[a]:
                        follow.setdefault(a, []).append(v)
                        eliminate(v, add_clique=False)
                        changed = True
        if not changed:
            break
    ids = np.flatnonzero(alive)
    remap = -np.ones(n, dtype=np.int64)
    remap[ids] = np.arange(len(ids))
    us, vs = [], []
    for v in ids:
        for u in adj[v]:
            if alive[u] and u > v:
                us.append(remap[v]); vs.append(remap[u])
    kernel = Graph.from_edges(len(ids), np.asarray(us, dtype=np.int64),
                              np.asarray(vs, dtype=np.int64),
                              vwgt=g.vwgt[ids])
    return kernel, ids, prefix, follow


def _min_degree_order(g: Graph) -> np.ndarray:
    """Dynamic minimum-degree (with elimination-graph updates) — base case."""
    adj = [set(g.neighbors(v).tolist()) for v in range(g.n)]
    alive = np.ones(g.n, dtype=bool)
    order = []
    for _ in range(g.n):
        live = np.flatnonzero(alive)
        v = int(live[np.argmin([len(adj[u]) for u in live])])
        order.append(v)
        alive[v] = False
        nbrs = [u for u in adj[v] if alive[u]]
        for i, a in enumerate(nbrs):        # clique the neighbourhood
            adj[a].discard(v)
            for b in nbrs[i + 1:]:
                adj[a].add(b)
                adj[b].add(a)
    return np.asarray(order, dtype=np.int64)


def _nested_dissection(g: Graph, ids: np.ndarray, out: list, seed: int,
                       preset: str, min_size: int = 64,
                       depth: int = 0, eps: float = 0.2,
                       device=None) -> None:
    if g.n <= min_size or depth > 24:
        out.extend(ids[_min_degree_order(g)].tolist())
        return
    # each subproblem owns a distinct seed (2s+1 / 2s+2 recursion below), so
    # siblings never share a separator RNG stream
    sep, part = multilevel_node_separator(g, eps=eps, preset=preset,
                                          seed=seed, device=device)
    in_sep = np.zeros(g.n, dtype=bool)
    in_sep[sep] = True
    a_mask = (part == 0) & ~in_sep
    b_mask = (part == 1) & ~in_sep
    if not a_mask.any() or not b_mask.any():
        out.extend(ids[_min_degree_order(g)].tolist())
        return
    ga, ia = g.subgraph(a_mask)
    gb, ib = g.subgraph(b_mask)
    _nested_dissection(ga, ids[ia], out, seed * 2 + 1, preset, min_size,
                       depth + 1, eps, device)
    _nested_dissection(gb, ids[ib], out, seed * 2 + 2, preset, min_size,
                       depth + 1, eps, device)
    out.extend(ids[np.flatnonzero(in_sep)].tolist())


class _NDNode:
    """One nested-dissection subproblem in the wave tree."""
    __slots__ = ("g", "ids", "seed", "depth", "leaf", "a", "b", "sep_ids")

    def __init__(self, g: Graph, ids: np.ndarray, seed: int, depth: int):
        self.g, self.ids, self.seed, self.depth = g, ids, seed, depth
        self.leaf = None
        self.a = self.b = self.sep_ids = None


def _nested_dissection_wave(g: Graph, ids: np.ndarray, out: list, seed: int,
                            preset: str, min_size: int = 64,
                            eps: float = 0.2, device=None) -> None:
    """Wave-order nested dissection: all subproblems at one recursion depth
    solve their separators in a single batched call
    (`nodesep_labels_wave`), so same-shape-bucket siblings share one
    batched tournament.  Seeds (2s+1 / 2s+2) and the post-order emit are
    exactly those of `_nested_dissection`, so the resulting ordering is
    bit-identical to the sequential recursion."""
    from repro_torch.core.nodesep.driver import (nodesep_labels_wave,
                                                 split_labels)
    root = _NDNode(g, ids, seed, 0)
    wave = [root]
    while wave:
        solve = []
        for nd in wave:
            if nd.g.n <= min_size or nd.depth > 24:
                nd.leaf = nd.ids[_min_degree_order(nd.g)]
            else:
                solve.append(nd)
        labs = (nodesep_labels_wave([nd.g for nd in solve], eps=eps,
                                    preset=preset,
                                    seeds=[nd.seed for nd in solve],
                                    device=device)
                if solve else [])
        wave = []
        for nd, lab in zip(solve, labs):
            sep, part = split_labels(lab)
            in_sep = np.zeros(nd.g.n, dtype=bool)
            in_sep[sep] = True
            a_mask = (part == 0) & ~in_sep
            b_mask = (part == 1) & ~in_sep
            if not a_mask.any() or not b_mask.any():
                nd.leaf = nd.ids[_min_degree_order(nd.g)]
                continue
            ga, ia = nd.g.subgraph(a_mask)
            gb, ib = nd.g.subgraph(b_mask)
            nd.a = _NDNode(ga, nd.ids[ia], nd.seed * 2 + 1, nd.depth + 1)
            nd.b = _NDNode(gb, nd.ids[ib], nd.seed * 2 + 2, nd.depth + 1)
            nd.sep_ids = nd.ids[np.flatnonzero(in_sep)]
            wave.extend((nd.a, nd.b))

    def emit(nd: _NDNode) -> None:          # depth ≤ 25 → recursion is fine
        if nd.leaf is not None:
            out.extend(nd.leaf.tolist())
            return
        emit(nd.a)
        emit(nd.b)
        out.extend(nd.sep_ids.tolist())

    emit(root)


def reduced_nd(g: Graph, preset: str = "eco", seed: int = 0,
               reduction_order=(0, 1, 2, 3, 4),
               eps: float = 0.2, batch_siblings: bool = True,
               device=None) -> np.ndarray:
    """Returns permutation ``order`` with order[i] = i-th eliminated vertex.

    ``eps`` is the separator imbalance threaded through the whole nested
    dissection recursion.  ``batch_siblings`` (default) runs the recursion
    in wave order so same-bucket sibling subproblems share batched device
    calls; the ordering is identical either way.  The separators run on
    ``device`` (None = CUDA; raises without a card unless
    ``device="cpu"``).  (The library's `ordering` output array is the
    inverse permutation — see interface.reduced_nd.)
    """
    dev = resolve_device(device)
    kernel, old_ids, prefix, follow = apply_reductions(g, reduction_order)
    out: list = []
    if kernel.n:
        if batch_siblings:
            _nested_dissection_wave(kernel, old_ids, out, seed, preset,
                                    eps=eps, device=dev)
        else:
            _nested_dissection(kernel, old_ids, out, seed, preset, eps=eps,
                               device=dev)
    order = list(prefix)
    seen = set(prefix)
    for v in out:
        order.append(v)
        seen.add(v)
        for f in follow.get(v, []):
            if f not in seen:
                order.append(f)
                seen.add(f)
    # merged members whose representative was itself reduced
    for rep, vs in follow.items():
        for f in vs:
            if f not in seen:
                order.append(f)
                seen.add(f)
    for v in range(g.n):
        if v not in seen:
            order.append(v)
            seen.add(v)
    return np.asarray(order, dtype=np.int64)


def fast_reduced_nd(g: Graph, seed: int = 0, eps: float = 0.2,
                    device=None) -> np.ndarray:
    return reduced_nd(g, preset="fast", seed=seed,
                      reduction_order=(0, 3, 4), eps=eps, device=device)


def fill_in(g: Graph, order: np.ndarray) -> int:
    """Symbolic Cholesky fill count under elimination ``order`` (benchmark
    metric; quadratic worst case — use on small graphs)."""
    pos = np.empty(g.n, dtype=np.int64)
    pos[order] = np.arange(g.n)
    adj = [set(g.neighbors(v).tolist()) for v in range(g.n)]
    fill = 0
    for v in order:
        later = [u for u in adj[v] if pos[u] > pos[v]]
        for i, a in enumerate(later):
            for b in later[i + 1:]:
                if b not in adj[a]:
                    adj[a].add(b)
                    adj[b].add(a)
                    fill += 1
    return fill
