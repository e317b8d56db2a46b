"""kahypar — the multilevel hypergraph partitioner driver.

The multilevel loop lives in the shared engine (core/multilevel.py); this
module provides the hypergraph `Medium` adapter and the ``kahypar`` program
entry.  Riding on the engine, hypergraphs get cut-protected iterated
V-cycles and ``time_limit`` restarts, and the pin-COO / ELL-H device views
are built once per hierarchy level and reused across refinement rounds,
initial tries, V-cycles and restarts.  A medium holds its device: every
view, generator and refinement of the run lands there.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import multilevel as ML
from repro_torch.core.csr import resolve_device
from repro_torch.core.refine import default_use_kernel
from repro_torch.core.hypergraph.container import (Hypergraph, to_ell_h,
                                                   to_pincoo)
from repro_torch.core.hypergraph import coarsen as C
from repro_torch.core.hypergraph import initial as I
from repro_torch.core.hypergraph import metrics as M
from repro_torch.core.hypergraph.refine import (refine_hypergraph,
                                                refine_hypergraph_batch)


@dataclasses.dataclass
class KahyparConfig:
    lp_iters: int = 8                   # clustering LP iterations per level
    refine_rounds: int = 10
    initial_tries: int = 4
    vcycles: int = 1                    # iterated multilevel cycles
    contraction_stop_factor: int = 20   # stop coarsening at ~factor*k nodes
    cluster_weight_factor: float = 3.0  # max cluster weight = W/(factor*k)
    stop_n_floor: int = 48              # never coarsen below this many nodes
    max_net_size: int = 64              # larger nets use the star fallback
    use_kernel: Optional[bool] = None   # None = CUDA kernel on a card


PRESETS = {
    "fast":   KahyparConfig(refine_rounds=6, initial_tries=2),
    "eco":    KahyparConfig(refine_rounds=10, initial_tries=4),
    "strong": KahyparConfig(refine_rounds=16, initial_tries=8,
                            contraction_stop_factor=30, vcycles=2),
}


class HypergraphMedium(ML.ViewCache):
    """The hypergraph adapter for the shared multilevel engine.

    ``recorder`` (an ``obs.Recorder``) opts this medium's engine runs into
    observability; it survives contraction, as does ``device`` (None =
    CUDA, which must be present).
    """

    def __init__(self, hg: Hypergraph, cfg: KahyparConfig,
                 objective: str = "km1", recorder=None, device=None):
        if objective not in ("km1", "cut"):
            raise ValueError(f"unknown objective {objective!r}")
        self.hg = hg
        self.cfg = cfg
        self.obj = objective
        self.recorder = recorder
        self.device = resolve_device(device)
        self.use_kernel = (default_use_kernel(self.device)
                           if cfg.use_kernel is None else cfg.use_kernel)

    # -- structure ---------------------------------------------------------
    @property
    def n(self) -> int:
        return self.hg.n

    @property
    def params(self) -> ML.EngineParams:
        cfg = self.cfg
        return ML.EngineParams(
            initial_tries=cfg.initial_tries, vcycles=cfg.vcycles,
            contraction_stop_factor=cfg.contraction_stop_factor,
            cluster_weight_factor=cfg.cluster_weight_factor,
            stop_n_floor=cfg.stop_n_floor, recorder=self.recorder)

    def total_vwgt(self) -> int:
        return self.hg.total_vwgt()

    def cluster(self, max_cluster_weight: float, seed: int,
                protect: Optional[Sequence[np.ndarray]] = None) -> np.ndarray:
        return C.lp_clustering(self.hg, max_cluster_weight,
                               iters=self.cfg.lp_iters, seed=seed,
                               max_net_size=self.cfg.max_net_size,
                               protect=protect, device=self.device)

    def contract(self, clusters: np.ndarray):
        coarse, cl = C.contract(self.hg, clusters)
        return HypergraphMedium(coarse, self.cfg, self.obj,
                                recorder=self.recorder,
                                device=self.device), cl

    # -- device views ------------------------------------------------------
    def build_views(self):
        hc = to_pincoo(self.hg, device=self.device)
        ell = (to_ell_h(self.hg, device=self.device) if self.use_kernel
               else None)
        return hc, ell

    # -- refinement --------------------------------------------------------
    def refine(self, part: np.ndarray, k: int, eps: float, seed: int,
               force_balance: Optional[bool] = None) -> np.ndarray:
        hc, ell = self.views
        if force_balance is None:
            force_balance = not M.is_feasible(self.hg, part, k, eps)
        out = refine_hypergraph(self.hg, part, k, eps,
                                rounds=self.cfg.refine_rounds, seed=seed,
                                objective=self.obj,
                                force_balance=force_balance,
                                use_kernel=self.use_kernel, hc=hc, ell=ell)
        rec = ML.recorder_of(self)
        if rec.enabled:
            rec.count("refine/rounds", self.cfg.refine_rounds)
            rec.count("refine/moves",
                      int(np.sum(out != np.asarray(part, dtype=np.int64))))
            if force_balance:
                rec.count("refine/forced_balance")
        return out

    def refine_batch(self, parts: Sequence[np.ndarray], k: int, eps: float,
                     seed: int) -> List[np.ndarray]:
        hc, ell = self.views
        return refine_hypergraph_batch(self.hg, list(parts), k, eps,
                                       rounds=self.cfg.refine_rounds,
                                       seed=seed, objective=self.obj,
                                       use_kernel=self.use_kernel,
                                       hc=hc, ell=ell)

    def polish(self, part: np.ndarray, k: int, eps: float,
               seed: int) -> np.ndarray:
        return part

    # -- initial partitioning ----------------------------------------------
    def initial_candidates(self, k: int, eps: float,
                           seed: int) -> List[np.ndarray]:
        return [I.greedy_growing(self.hg, k, seed=seed + 101 * t)
                if t % 2 == 0
                else I.random_partition(self.hg, k, seed=seed + 101 * t)
                for t in range(self.cfg.initial_tries)]

    # -- objective ---------------------------------------------------------
    def objective(self, part: np.ndarray) -> float:
        score = M.connectivity if self.obj == "km1" else M.cut_net
        return float(score(self.hg, part))

    def imbalance(self, part: np.ndarray, k: int) -> float:
        return M.balance(self.hg, part, k)

    def is_feasible(self, part: np.ndarray, k: int, eps: float) -> bool:
        return M.is_feasible(self.hg, part, k, eps)


def multilevel_hypergraph_partition(hg: Hypergraph, k: int, eps: float,
                                    cfg: KahyparConfig, seed: int,
                                    objective: str,
                                    device=None) -> np.ndarray:
    return ML.multilevel(HypergraphMedium(hg, cfg, objective, device=device),
                         k, eps, seed)


def kahypar(hg: Hypergraph, k: int, eps: float = 0.03, preset: str = "eco",
            seed: int = 0, objective: str = "km1",
            input_partition: Optional[np.ndarray] = None,
            vcycles: Optional[int] = None,
            time_limit: float = 0.0, report=None,
            device=None) -> np.ndarray:
    """The ``kahypar`` program: multilevel hypergraph partitioning on
    ``device`` (None = CUDA; raises without a card unless
    ``device="cpu"``).

    ``objective`` ∈ {"km1", "cut"}; returns a block id per vertex.
    ``vcycles`` overrides the preset's iterated-multilevel count and
    ``time_limit`` enables repeated restarts under a wall-clock budget —
    both engine features shared with kaffpa.  ``report`` is an optional
    ``obs.Recorder`` capturing this run's spans, counters and quality
    trajectory.
    """
    if objective not in ("km1", "cut"):
        raise ValueError(f"unknown objective {objective!r}")
    dev = resolve_device(device)
    cfg = PRESETS[preset]
    if k <= 1:
        return np.zeros(hg.n, dtype=np.int64)
    medium = HypergraphMedium(hg, cfg, objective, recorder=report,
                              device=dev)
    return ML.run(medium, k, eps, seed, vcycles=vcycles,
                  time_limit=time_limit, input_partition=input_partition)
