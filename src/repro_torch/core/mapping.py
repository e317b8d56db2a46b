"""Process mapping (paper §2.6, §4.8) — map k processes onto a hierarchical
processor network, minimizing the QAP objective

    J(σ) = Σ_{p,q} comm(p, q) · dist(σ(p), σ(q)) .

``hierarchy_parameter_string`` "4:8:8" means 4 cores/PE, 8 PEs/rack, 8 racks;
``distance_parameter_string`` "1:10:100" gives the distance charged at each
level of the deepest common ancestor.  k = prod(hierarchy).

Algorithms (paper): *global multisection* — recursively partition the
communication graph along the hierarchy top-down with perfectly-balanced
KaFFPa calls — plus a pairwise-swap local search.  ``MAPMODE_BISECTION``
falls back to recursive bisection into prod() blocks.

The search is host numpy over (k, k) matrices; the partitioning calls
underneath (kaffpa, KaBaPE's balance_path) run on ``device`` (None = CUDA;
raises without a card unless ``device="cpu"``).  launch/topology.py maps a
device mesh's communication pattern the same way.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.csr import Graph
from repro_torch.core.kaffpa import kaffpa
from repro_torch.core.kabape import balance_path

MAPMODE_MULTISECTION = 0
MAPMODE_BISECTION = 1


def parse_hierarchy(hierarchy: str | Sequence[int],
                    distances: str | Sequence[int]):
    if isinstance(hierarchy, str):
        hierarchy = [int(x) for x in hierarchy.split(":")]
    if isinstance(distances, str):
        distances = [int(x) for x in distances.split(":")]
    if len(hierarchy) != len(distances):
        raise ValueError(f"hierarchy/distance mismatch: {hierarchy} vs "
                         f"{distances}")
    return list(hierarchy), list(distances)


def processor_distance_matrix(hierarchy: Sequence[int],
                              distances: Sequence[int]) -> np.ndarray:
    """dist[i, j] between processors in hierarchical numbering.

    Processor id = mixed-radix number, *innermost level first*: with 4:8:8,
    id = core + 4·(pe + 8·rack).  dist = distances[highest differing level].
    """
    k = int(np.prod(hierarchy))
    ids = np.arange(k)
    coords = []
    rest = ids
    for h in hierarchy:
        coords.append(rest % h)
        rest = rest // h
    dist = np.zeros((k, k), dtype=np.int64)
    for lvl in range(len(hierarchy) - 1, -1, -1):
        differ = coords[lvl][:, None] != coords[lvl][None, :]
        dist = np.where((dist == 0) & differ, distances[lvl], dist)
    return dist


def qap_cost(comm: np.ndarray, dist: np.ndarray,
             mapping: np.ndarray) -> int:
    """mapping[p] = processor of process p."""
    d = dist[mapping[:, None], mapping[None, :]]
    return int((comm * d).sum()) // 2


def _comm_graph(comm: np.ndarray) -> Graph:
    k = comm.shape[0]
    u, v = np.triu_indices(k, 1)
    w = comm[u, v]
    keep = w > 0
    # kaffpa needs positive integer weights
    return Graph.from_edges(k, u[keep], v[keep],
                            np.maximum(w[keep], 1).astype(np.int64))


def _multisection(comm: np.ndarray, hierarchy: Sequence[int],
                  seed: int, preset: str = "eco",
                  device=None) -> np.ndarray:
    """Top-down recursive multisection along the hierarchy (outermost level
    first).  Returns processor id per process (innermost-first mixed radix).
    """
    k = comm.shape[0]
    procs = np.zeros(k, dtype=np.int64)

    def recurse(ids: np.ndarray, levels: list, base: int):
        if len(levels) == 0 or len(ids) <= 1:
            # leaf: assign consecutive processor ids
            for i, p in enumerate(ids):
                procs[p] = base + i
            return
        parts_at_level = levels[-1]            # outermost level size
        sub = comm[np.ix_(ids, ids)]
        gsub = _comm_graph(sub)
        if gsub.m == 0:
            blk = np.arange(len(ids)) % parts_at_level
        else:
            blk = kaffpa(gsub, parts_at_level, 0.0, preset, seed=seed,
                         enforce_balance=True, device=device)
            if np.bincount(blk, minlength=parts_at_level).max() \
                    > len(ids) // parts_at_level:
                blk = balance_path(gsub, blk, parts_at_level, 0.0,
                                   device=device)
            # hard guarantee: exact equal sizes (arbitrary moves if needed)
            want = len(ids) // parts_at_level
            sizes = np.bincount(blk, minlength=parts_at_level)
            for b in range(parts_at_level):
                while sizes[b] > want:
                    under = int(np.argmin(sizes))
                    victim = np.flatnonzero(blk == b)[-1]
                    blk[victim] = under
                    sizes[b] -= 1
                    sizes[under] += 1
        inner = int(np.prod(levels[:-1])) if len(levels) > 1 else 1
        for b in range(parts_at_level):
            sel = ids[blk == b]
            recurse(sel, levels[:-1], base + b * inner)

    recurse(np.arange(k), list(hierarchy), 0)
    return procs


def _swap_local_search(comm: np.ndarray, dist: np.ndarray,
                       mapping: np.ndarray, iters: int = 3) -> np.ndarray:
    """Pairwise-swap hill climbing on the QAP objective (paper's fast local
    search, restricted to pairs with nonzero communication)."""
    mapping = mapping.copy()
    k = len(mapping)
    pairs = np.argwhere(comm > 0)
    pairs = pairs[pairs[:, 0] < pairs[:, 1]]
    for _ in range(iters):
        improved = False
        cur = qap_cost(comm, dist, mapping)
        for (p, q) in pairs:
            mapping[p], mapping[q] = mapping[q], mapping[p]
            c = qap_cost(comm, dist, mapping)
            if c < cur:
                cur = c
                improved = True
            else:
                mapping[p], mapping[q] = mapping[q], mapping[p]
        if not improved:
            break
    return mapping


def process_mapping(comm: np.ndarray, hierarchy, distances,
                    mode: int = MAPMODE_MULTISECTION, seed: int = 0,
                    local_search: bool = True, device=None) -> np.ndarray:
    """The ``process_mapping`` library call / ``global_multisection`` program.

    comm: (k, k) symmetric nonnegative communication matrix.
    Returns mapping[p] = processor id.
    """
    hierarchy, distances = parse_hierarchy(hierarchy, distances)
    k = int(np.prod(hierarchy))
    if comm.shape != (k, k):
        raise ValueError(f"comm must be ({k},{k}), got {comm.shape}")
    if mode == MAPMODE_MULTISECTION:
        mapping = _multisection(comm, hierarchy, seed, device=device)
    else:
        # bisection mode: one flat perfectly-balanced k-partition is the
        # identity here (k singleton blocks) → start from identity
        mapping = np.arange(k, dtype=np.int64)
    if local_search:
        dist = processor_distance_matrix(hierarchy, distances)
        mapping = _swap_local_search(comm, dist, mapping)
    return mapping


def kaffpa_with_mapping(g: Graph, hierarchy, distances, eps: float = 0.03,
                        preset: str = "eco", seed: int = 0,
                        device=None) -> tuple:
    """kaffpa --enable_mapping: partition into k = prod(hierarchy) blocks,
    then map blocks to processors (§4.1).  Returns (part, mapping, qap)."""
    hierarchy, distances = parse_hierarchy(hierarchy, distances)
    k = int(np.prod(hierarchy))
    part = kaffpa(g, k, eps, preset, seed=seed, device=device)
    # block-level communication volume matrix
    src = g.edge_sources()
    comm = np.zeros((k, k), dtype=np.int64)
    ext = part[src] != part[g.adjncy]
    np.add.at(comm, (part[src[ext]], part[g.adjncy[ext]]), g.adjwgt[ext])
    mapping = process_mapping(comm, hierarchy, distances, seed=seed,
                              device=device)
    dist = processor_distance_matrix(hierarchy, distances)
    return part, mapping, qap_cost(comm, dist, mapping)
