"""Edge partitioning via the split-and-connect (SPAC) model (paper §2.7).

Every vertex v of degree d is split into d *split vertices*, one per
incident edge, connected in a cycle by auxiliary edges of weight
``infinity`` (the --infinity option).  Every original edge becomes a
unit-weight edge between the two corresponding split vertices.  A node
partition of the SPAC graph induces an edge partition of the original graph;
the heavy auxiliary cycles keep a vertex's split copies together, minimizing
vertex replication.  The SPAC graph is partitioned by kaffpa's engine on a
device (None = CUDA), or by parhip on a `core.mesh.Mesh`
(``distributed_edge_partition``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.csr import Graph
from repro_torch.core import multilevel as ML
from repro_torch.core.kaffpa import PRESETS, GraphMedium


def build_spac(g: Graph, infinity: int = 1000):
    """Returns (spac graph, edge→split-vertex map (m, 2))."""
    src = g.edge_sources()
    fwd = src < g.adjncy                     # canonical undirected edges
    eu, ev = src[fwd], g.adjncy[fwd]
    m = len(eu)
    # split vertex id = position of the directed edge in adjncy
    # for edge j with endpoints (u, v): splits are the two directed slots
    dir_id = np.arange(len(src))
    # map each canonical edge to its two directed slots
    key_fwd = eu * np.int64(g.n) + ev
    key_all = src * np.int64(g.n) + g.adjncy
    key_rev = ev * np.int64(g.n) + eu
    order_all = np.argsort(key_all)
    pos_fwd = order_all[np.searchsorted(key_all[order_all], key_fwd)]
    pos_rev = order_all[np.searchsorted(key_all[order_all], key_rev)]
    esplit = np.stack([pos_fwd, pos_rev], axis=1)     # (m, 2) split ids
    # unit edges between the two split vertices of each original edge
    spac_u = [pos_fwd]
    spac_v = [pos_rev]
    spac_w = [np.ones(m, dtype=np.int64)]
    # auxiliary cycles per original vertex
    deg = g.degrees()
    for v in range(g.n):
        lo, hi = g.xadj[v], g.xadj[v + 1]
        ids = dir_id[lo:hi]
        d = len(ids)
        if d >= 2:
            nxt = np.roll(ids, -1)
            if d == 2:     # avoid parallel edges on a 2-cycle
                spac_u.append(ids[:1]); spac_v.append(nxt[:1])
                spac_w.append(np.full(1, infinity, dtype=np.int64))
            else:
                spac_u.append(ids); spac_v.append(nxt)
                spac_w.append(np.full(d, infinity, dtype=np.int64))
    nspac = len(src)
    spac = Graph.from_edges(nspac, np.concatenate(spac_u),
                            np.concatenate(spac_v), np.concatenate(spac_w),
                            dedup=True)
    return spac, esplit


def spac_medium(g: Graph, preset: str = "eco", infinity: int = 1000,
                device=None):
    """The edge-partitioning adapter onto the shared engine: a `GraphMedium`
    of the SPAC graph on ``device``.  The infinity-weight auxiliary cycles
    survive every engine phase structurally: heavy-edge matching contracts
    them first, and under protected re-coarsening (V-cycles) an auxiliary
    edge is only left uncontracted when the protected partition already
    cuts it — in which case refinement's huge gain for healing it keeps
    split copies together.

    Returns (medium, esplit) — partition ``medium`` with ``multilevel.run``
    and map blocks through ``esplit[:, 0]``.
    """
    spac, esplit = build_spac(g, infinity)
    return GraphMedium(spac, PRESETS[preset], device=device), esplit


def edge_partition(g: Graph, k: int, eps: float = 0.03,
                   preset: str = "eco", infinity: int = 1000,
                   seed: int = 0, vcycles: Optional[int] = None,
                   time_limit: float = 0.0, device=None) -> np.ndarray:
    """The ``edge_partitioning`` program: returns block id per canonical
    undirected edge (lo<hi order, matching Graph.from_edges).

    Drives the shared multilevel engine on a `GraphMedium` of the SPAC
    graph on ``device`` (None = CUDA; raises without a card unless
    ``device="cpu"``), so V-cycles and time-budget restarts apply to edge
    partitioning like every other medium."""
    medium, esplit = spac_medium(g, preset, infinity, device=device)
    part = ML.run(medium, k, eps, seed, vcycles=vcycles,
                  time_limit=time_limit)
    # edge block: block of its first split vertex (splits almost always agree
    # thanks to the infinity cycles)
    return part[esplit[:, 0]]


def distributed_edge_partition(g: Graph, k: int, eps: float = 0.03,
                               preconfiguration: str = "fastmesh",
                               infinity: int = 1000, seed: int = 0,
                               mesh=None, device=None) -> np.ndarray:
    """The ``distributed_edge_partitioning`` program: ParHIP on the SPAC
    graph (§4.6), on ``mesh`` or, without one, a world of one on
    ``device`` (None = CUDA; raises without a card unless
    ``device="cpu"``)."""
    from repro_torch.core.parhip import parhip
    spac, esplit = build_spac(g, infinity)
    part = parhip(spac, k, eps, preconfiguration, seed=seed, mesh=mesh,
                  device=device)
    return part[esplit[:, 0]]


def naive_edge_partition(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    """Baseline: random balanced edge assignment (for benchmarks)."""
    rng = np.random.default_rng(seed)
    m = g.m
    blk = np.repeat(np.arange(k), (m + k - 1) // k)[:m]
    return blk[rng.permutation(m)]
