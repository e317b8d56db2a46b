"""The KaHIP library interface (paper §5) — Python mirror of
``interface/kaHIP_interface.h``.

Functions take the CSR arrays (n, vwgt, xadj, adjcwgt, adjncy) exactly as the
C API does (vwgt/adjcwgt may be None; the orderings take xadj/adjncy
only), or for ``kahypar`` the hMETIS arrays (eptr, eind), and return the C
API's output parameters as Python values.  ``device=None`` runs on CUDA
and raises without a card; pass ``device="cpu"`` to run on the CPU.  The
distributed entries (``parhyp``, and ``kaffpaE``/``kahyparE`` with a
``mesh``) run on the mesh's device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.csr import Graph

# mode constants (paper §5.2)
FAST, ECO, STRONG, FASTSOCIAL, ECOSOCIAL, STRONGSOCIAL = range(6)
_MODE_NAMES = {FAST: "fast", ECO: "eco", STRONG: "strong",
               FASTSOCIAL: "fastsocial", ECOSOCIAL: "ecosocial",
               STRONGSOCIAL: "strongsocial"}

MAPMODE_MULTISECTION = 0
MAPMODE_BISECTION = 1


def _graph(n, vwgt, xadj, adjcwgt, adjncy) -> Graph:
    return Graph.from_arrays(np.asarray(xadj), np.asarray(adjncy),
                             None if vwgt is None else np.asarray(vwgt),
                             None if adjcwgt is None else np.asarray(adjcwgt))


def kaffpa(n: int, vwgt, xadj, adjcwgt, adjncy, nparts: int,
           imbalance: float, suppress_output: bool = True, seed: int = 0,
           mode: int = ECO, report=None, device=None):
    """Main partitioner call → (edgecut, part).

    ``report`` is an optional ``obs.Recorder`` capturing spans, counters
    and the quality trajectory of this run.
    """
    from repro_torch.core import kaffpa as K
    from repro_torch.core.partition import edge_cut
    g = _graph(n, vwgt, xadj, adjcwgt, adjncy)
    part = K.kaffpa(g, nparts, imbalance, _MODE_NAMES[mode], seed=seed,
                    report=report, device=device)
    return edge_cut(g, part), part


def kaffpa_balance_NE(n: int, vwgt, xadj, adjcwgt, adjncy, nparts: int,
                      imbalance: float, suppress_output: bool = True,
                      seed: int = 0, mode: int = ECO, report=None,
                      device=None):
    """Node+edge balanced partitioner call → (edgecut, part)."""
    from repro_torch.core import kaffpa as K
    from repro_torch.core.partition import edge_cut
    g = _graph(n, vwgt, xadj, adjcwgt, adjncy)
    part = K.kaffpa(g, nparts, imbalance, _MODE_NAMES[mode], seed=seed,
                    balance_edges=True, report=report, device=device)
    return edge_cut(g, part), part


def kaffpaE(n: int, vwgt, xadj, adjcwgt, adjncy, nparts: int,
            imbalance: float, time_limit: float = 10.0,
            suppress_output: bool = True, seed: int = 0, mode: int = ECO,
            n_islands: int = 4, population: int = 4, mesh=None,
            generations=None, report=None, device=None):
    """Memetic partitioner call (the ``kaffpaE`` program on the
    core/memetic island driver) → (edgecut, part).

    Validates the memetic knobs up front (``n_islands``/``population``
    must be positive, ``time_limit`` finite and >= 0 — 0 keeps the paper's
    initial-population-only semantics); ``generations`` selects a
    deterministic generation count instead of the wall-clock budget.
    ``mesh`` (a `core.mesh.Mesh`) lays the islands out over its ranks for
    migration; every rank makes this call alike.
    """
    from repro_torch.core import evolve as E
    from repro_torch.core.partition import edge_cut
    g = _graph(n, vwgt, xadj, adjcwgt, adjncy)
    with obs.use(report):
        part = E.kaffpaE(g, nparts, imbalance, _MODE_NAMES[mode],
                         n_islands=n_islands, population=population,
                         time_limit=time_limit, seed=seed, mesh=mesh,
                         generations=generations, device=device)
    return edge_cut(g, part), part


def _hypergraph(n, vwgt, ewgt, eptr, eind):
    from repro_torch.core import hypergraph as H
    return H.Hypergraph.from_arrays(
        n, np.asarray(eptr), np.asarray(eind),
        None if ewgt is None else np.asarray(ewgt),
        None if vwgt is None else np.asarray(vwgt))


def kahypar(n: int, m: int, vwgt, ewgt, eptr, eind, nparts: int,
            imbalance: float, suppress_output: bool = True, seed: int = 0,
            mode: int = ECO, objective: str = "km1",
            vcycles: Optional[int] = None, time_limit: float = 0.0,
            report=None, device=None):
    """Hypergraph partitioner call (KaHyPar-style C API) → (objval, part).

    ``eptr``/``eind`` are the hMETIS CSR arrays (m+1 offsets, pin ids);
    ``vwgt``/``ewgt`` may be None.  ``objective`` ∈ {"km1", "cut"} selects
    connectivity (λ−1) or cut-net; ``objval`` is the objective achieved.
    ``vcycles``/``time_limit`` are the shared engine's iterated-multilevel
    and restart-budget knobs (same semantics as the kaffpa entry).
    """
    from repro_torch.core import hypergraph as H
    hg = _hypergraph(n, vwgt, ewgt, eptr, eind)
    preset = _MODE_NAMES[mode].replace("social", "")   # no social split here
    part = H.kahypar(hg, nparts, imbalance, preset, seed=seed,
                     objective=objective, vcycles=vcycles,
                     time_limit=time_limit, report=report, device=device)
    score = H.connectivity if objective == "km1" else H.cut_net
    return score(hg, part), part


def kahyparE(n: int, m: int, vwgt, ewgt, eptr, eind, nparts: int,
             imbalance: float, time_limit: float = 10.0,
             suppress_output: bool = True, seed: int = 0, mode: int = ECO,
             objective: str = "km1", n_islands: int = 2,
             population: int = 2, generations=None, mesh=None,
             report=None, device=None):
    """Memetic hypergraph partitioner call (the ``kahyparE`` program) →
    (objval, part).

    Same array convention as the ``kahypar`` entry; ``objective`` ∈
    {"km1", "cut"}.  The memetic knobs are validated up front;
    ``generations`` selects a deterministic generation count instead of
    the ``time_limit`` wall-clock budget; ``mesh`` (a `core.mesh.Mesh`)
    lays the islands out over its ranks, and on several ranks every child
    also gets the distributed parhyp polish.
    """
    from repro_torch.core import hypergraph as H
    hg = _hypergraph(n, vwgt, ewgt, eptr, eind)
    preset = _MODE_NAMES[mode].replace("social", "")   # no social split here
    part = H.kahyparE(hg, nparts, imbalance, preset, seed=seed,
                      objective=objective, n_islands=n_islands,
                      population=population, time_limit=time_limit,
                      generations=generations, mesh=mesh, report=report,
                      device=device)
    score = H.connectivity if objective == "km1" else H.cut_net
    return score(hg, part), part


def parhyp(n: int, m: int, vwgt, ewgt, eptr, eind, nparts: int,
           imbalance: float, suppress_output: bool = True, seed: int = 0,
           preconfiguration: str = "fast", objective: str = "km1",
           mesh=None, report=None, device=None):
    """Distributed hypergraph partitioner call (the ``parhyp`` program)
    → (objval, part).

    Same array convention as the ``kahypar`` entry; ``preconfiguration``
    ∈ {"ultrafast", "fast", "eco"} selects the engine preset and the
    distributed-LP round count, ``mesh`` an optional `core.mesh.Mesh` —
    1-D ``("nets",)`` or 2-D ``("nets", "verts")``, every rank making
    this call alike — and without one the run is a world of one on
    ``device``.  Above the gather-to-one-PE floor the whole V-cycle
    (LP-clustering coarsening, contraction, refinement) stays on the
    device; small inputs run the host-orchestrated multilevel with
    distributed refinement.
    """
    from repro_torch.core import hypergraph as H
    hg = _hypergraph(n, vwgt, ewgt, eptr, eind)
    part = H.parhyp(hg, nparts, imbalance,
                    preconfiguration=preconfiguration, seed=seed,
                    mesh=mesh, objective=objective, report=report,
                    device=device)
    score = H.connectivity if objective == "km1" else H.cut_net
    return score(hg, part), part


def node_separator(n: int, vwgt, xadj, adjcwgt, adjncy, nparts: int,
                   imbalance: float, suppress_output: bool = True,
                   seed: int = 0, mode: int = ECO, multilevel: bool = True,
                   memetic: bool = False, time_limit: float = 5.0,
                   n_islands: int = 2, population: int = 2, report=None,
                   device=None):
    """→ (num_separator_vertices, separator ids).

    nparts == 2 (the recommended §5.2 setting) runs the multilevel
    separator engine (core/nodesep), which optimizes separator weight at
    every hierarchy level; ``memetic=True`` evolves separator states on
    the memetic island driver instead (``time_limit`` seconds,
    ``n_islands`` × ``population``); ``multilevel=False`` selects the
    post-hoc two-step construction (partition, then vertex-cover the
    boundary).  nparts > 2 always uses the pairwise post-hoc construction.
    """
    from repro_torch.core import kaffpa as K
    from repro_torch.core import separator as S
    g = _graph(n, vwgt, xadj, adjcwgt, adjncy)
    if nparts == 2 and memetic:
        from repro_torch.core.nodesep import memetic_node_separator
        sep, _ = memetic_node_separator(g, imbalance, _MODE_NAMES[mode],
                                        seed=seed, n_islands=n_islands,
                                        population=population,
                                        time_limit=time_limit,
                                        report=report, device=device)
        return len(sep), sep
    if nparts == 2 and multilevel:
        from repro_torch.core.nodesep import multilevel_node_separator
        sep, _ = multilevel_node_separator(g, imbalance, _MODE_NAMES[mode],
                                           seed=seed, report=report,
                                           device=device)
        return len(sep), sep
    with obs.use(report):
        part = K.kaffpa(g, nparts, imbalance, _MODE_NAMES[mode], seed=seed,
                        device=device)
        if nparts == 2:
            sep, _ = S.node_separator(g, imbalance, _MODE_NAMES[mode], seed,
                                      part=part)
        else:
            sep = S.partition_to_vertex_separator(g, part, nparts)
    return len(sep), sep


def _inverse(order: np.ndarray) -> np.ndarray:
    inv = np.empty(len(order), dtype=np.int64)
    inv[order] = np.arange(len(order))
    return inv


def reduced_nd(n: int, xadj, adjncy, suppress_output: bool = True,
               seed: int = 0, mode: int = ECO, device=None):
    """Node ordering → ordering array (ordering[v] = elimination position)."""
    from repro_torch.core import ordering as O
    g = _graph(n, None, xadj, None, adjncy)
    return _inverse(O.reduced_nd(g, _MODE_NAMES[mode], seed=seed,
                                 device=device))


def fast_reduced_nd(n: int, xadj, adjncy, suppress_output: bool = True,
                    seed: int = 0, mode: int = FAST, device=None):
    """The fast node ordering (fast preset, reductions 0, 3, 4) →
    ordering array (ordering[v] = elimination position)."""
    from repro_torch.core import ordering as O
    g = _graph(n, None, xadj, None, adjncy)
    return _inverse(O.fast_reduced_nd(g, seed=seed, device=device))


def process_mapping(n: int, vwgt, xadj, adjcwgt, adjncy,
                    hierarchy_parameter: Sequence[int],
                    distance_parameter: Sequence[int],
                    hierarchy_depth: int, imbalance: float,
                    suppress_output: bool = True, seed: int = 0,
                    mode_partitioning: int = ECO,
                    mode_mapping: int = MAPMODE_MULTISECTION, device=None):
    """→ (edgecut, qap, part) — §5.2 Process Mapping: a kaffpa partition
    into prod(hierarchy) blocks, each block's id mapped to its processor."""
    from repro_torch.core import mapping as M
    from repro_torch.core.partition import edge_cut
    g = _graph(n, vwgt, xadj, adjcwgt, adjncy)
    hierarchy = list(hierarchy_parameter)[:hierarchy_depth]
    distances = list(distance_parameter)[:hierarchy_depth]
    part, mapping, qap = M.kaffpa_with_mapping(
        g, hierarchy, distances, imbalance,
        _MODE_NAMES[mode_partitioning], seed=seed, device=device)
    # remap block ids through the processor assignment
    final = mapping[part]
    return edge_cut(g, final), qap, final
