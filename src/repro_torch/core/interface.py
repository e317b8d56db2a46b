"""The KaHIP library interface (paper §5) — Python mirror of
``interface/kaHIP_interface.h``.

Functions take the CSR arrays (n, vwgt, xadj, adjcwgt, adjncy) exactly as the
C API does (vwgt/adjcwgt may be None) and return the C API's output
parameters as Python values.  ``device=None`` runs on CUDA and raises
without a card; pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

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
