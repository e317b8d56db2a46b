"""The KaHIP library interface (paper §5) — Python mirror of
``interface/kaHIP_interface.h``.

Functions take the CSR arrays (n, vwgt, xadj, adjcwgt, adjncy) exactly as the
C API does (vwgt/adjcwgt may be None), or for ``kahypar`` the hMETIS
arrays (eptr, eind), and return the C API's output parameters as Python
values.  ``device=None`` runs on CUDA and raises
without a card; pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.csr import Graph

# mode constants (paper §5.2)
FAST, ECO, STRONG, FASTSOCIAL, ECOSOCIAL, STRONGSOCIAL = range(6)
_MODE_NAMES = {FAST: "fast", ECO: "eco", STRONG: "strong",
               FASTSOCIAL: "fastsocial", ECOSOCIAL: "ecosocial",
               STRONGSOCIAL: "strongsocial"}


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
    hg = H.Hypergraph.from_arrays(
        n, np.asarray(eptr), np.asarray(eind),
        None if ewgt is None else np.asarray(ewgt),
        None if vwgt is None else np.asarray(vwgt))
    preset = _MODE_NAMES[mode].replace("social", "")   # no social split here
    part = H.kahypar(hg, nparts, imbalance, preset, seed=seed,
                     objective=objective, vcycles=vcycles,
                     time_limit=time_limit, report=report, device=device)
    score = H.connectivity if objective == "km1" else H.cut_net
    return score(hg, part), part
