"""KaFFPa — the multilevel partitioner (paper §2.1, §4.1).

Preconfigurations follow the paper's use-case table: {fast, eco, strong} for
mesh-like graphs (matching coarsening) and {fastsocial, ecosocial,
strongsocial} for social networks (size-constrained LP coarsening, §2.4).

`strong` additionally runs pairwise max-flow refinement on small levels and
an iterated V-cycle with cut-edge-protected re-coarsening (§2.1, Walshaw
iterated multilevel — quality is non-decreasing because refinement never
worsens and protected coarsening keeps the current partition representable).

The multilevel loop lives in the engine (core/multilevel.py); this module
provides the graph `Medium` adapter and the ``kaffpa`` program entry.  A
medium holds its device: every view, generator and refinement of the run
lands there.  The COO (and ELL, when the CUDA kernel path is active) views
are built once per hierarchy level and reused across refinement rounds,
initial tries, V-cycles and time-budget restarts.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.csr import Graph, resolve_device, to_coo, to_ell
from repro_torch.core import coarsen as C
from repro_torch.core import initial as I
from repro_torch.core import multilevel as ML
from repro_torch.core import refine as R
from repro_torch.core.partition import balance, edge_cut, is_feasible


@dataclasses.dataclass
class KaffpaConfig:
    coarsening: str = "matching"        # matching | lp
    lp_iters: int = 8
    refine_rounds: int = 10
    multi_try: int = 0                  # localized-search restarts per level
    use_flow: bool = False              # pairwise max-flow refinement
    flow_max_n: int = 6000
    initial_tries: int = 4
    vcycles: int = 1                    # iterated multilevel cycles
    contraction_stop_factor: int = 40   # stop coarsening at ~factor*k nodes
    cluster_weight_factor: float = 3.0  # max cluster weight = W/(factor*k)
    stop_n_floor: int = 64              # never coarsen below this many nodes
    use_kernel: Optional[bool] = None   # None = CUDA kernel on a card


PRESETS = {
    "fast":         KaffpaConfig(coarsening="matching", refine_rounds=6,
                                 initial_tries=2),
    "eco":          KaffpaConfig(coarsening="matching", refine_rounds=10,
                                 multi_try=2, initial_tries=4),
    "strong":       KaffpaConfig(coarsening="matching", refine_rounds=14,
                                 multi_try=3, use_flow=True, initial_tries=6,
                                 vcycles=2),
    "fastsocial":   KaffpaConfig(coarsening="lp", refine_rounds=6,
                                 initial_tries=2),
    "ecosocial":    KaffpaConfig(coarsening="lp", refine_rounds=10,
                                 multi_try=2, initial_tries=4),
    "strongsocial": KaffpaConfig(coarsening="lp", refine_rounds=14,
                                 multi_try=3, use_flow=True, initial_tries=6,
                                 vcycles=2),
}


class GraphMedium(ML.ViewCache):
    """The graph adapter for the multilevel engine.

    ``recorder`` (an ``obs.Recorder``) opts this medium's engine runs into
    observability; it rides ``EngineParams`` and survives contraction, as
    does ``device`` (None = CUDA, which must be present).
    """

    def __init__(self, g: Graph, cfg: KaffpaConfig, recorder=None,
                 device=None):
        self.g = g
        self.cfg = cfg
        self.recorder = recorder
        self.device = resolve_device(device)
        self.use_kernel = (R.default_use_kernel(self.device)
                           if cfg.use_kernel is None else cfg.use_kernel)

    # -- structure ---------------------------------------------------------
    @property
    def n(self) -> int:
        return self.g.n

    @property
    def params(self) -> ML.EngineParams:
        cfg = self.cfg
        return ML.EngineParams(
            initial_tries=cfg.initial_tries, vcycles=cfg.vcycles,
            contraction_stop_factor=cfg.contraction_stop_factor,
            cluster_weight_factor=cfg.cluster_weight_factor,
            stop_n_floor=cfg.stop_n_floor, recorder=self.recorder)

    def total_vwgt(self) -> int:
        return self.g.total_vwgt()

    def cluster(self, max_cluster_weight: float, seed: int,
                protect: Optional[Sequence[np.ndarray]] = None) -> np.ndarray:
        g = self.g
        forbidden = None
        if protect:
            forbidden = ML.protect_cut_mask(g.edge_sources(), g.adjncy,
                                            protect)
        if self.cfg.coarsening == "lp":
            return C.lp_clustering(g, max_cluster_weight,
                                   iters=self.cfg.lp_iters, seed=seed,
                                   forbidden=forbidden, device=self.device)
        return C.heavy_edge_matching(g, seed=seed,
                                     max_cluster_weight=max_cluster_weight,
                                     forbidden=forbidden)

    def contract(self, clusters: np.ndarray):
        coarse, cl = C.contract(self.g, clusters)
        return GraphMedium(coarse, self.cfg, recorder=self.recorder,
                           device=self.device), cl

    # -- device views ------------------------------------------------------
    def build_views(self):
        coo = to_coo(self.g, device=self.device)
        ell = (to_ell(self.g, row_tile=coo.n_pad, device=self.device)
               if self.use_kernel else None)
        return coo, ell

    # -- refinement --------------------------------------------------------
    def refine(self, part: np.ndarray, k: int, eps: float, seed: int,
               force_balance: Optional[bool] = None) -> np.ndarray:
        g, cfg = self.g, self.cfg
        coo, ell = self.views
        if force_balance is None:
            force_balance = not is_feasible(g, part, k, eps)
        out = R.refine_kway(g, part, k, eps, rounds=cfg.refine_rounds,
                            seed=seed, coo=coo, ell=ell,
                            use_kernel=self.use_kernel,
                            force_balance=force_balance)
        rec = ML.recorder_of(self)
        if rec.enabled:
            rec.count("refine/rounds", cfg.refine_rounds)
            rec.count("refine/moves",
                      int(np.sum(out != np.asarray(part, dtype=np.int64))))
            if force_balance:
                rec.count("refine/forced_balance")
        return self.polish(out, k, eps, seed)

    def refine_batch(self, parts: Sequence[np.ndarray], k: int, eps: float,
                     seed: int, seeds: Optional[Sequence[int]] = None
                     ) -> List[np.ndarray]:
        coo, ell = self.views
        return R.refine_kway_batch(self.g, list(parts), k, eps,
                                   rounds=self.cfg.refine_rounds, seed=seed,
                                   coo=coo, ell=ell,
                                   use_kernel=self.use_kernel, seeds=seeds)

    def polish(self, part: np.ndarray, k: int, eps: float,
               seed: int) -> np.ndarray:
        g, cfg = self.g, self.cfg
        coo, _ = self.views
        if cfg.multi_try:
            part = R.multi_try_refine(g, part, k, eps, tries=cfg.multi_try,
                                      rounds=max(4, cfg.refine_rounds // 2),
                                      seed=seed, coo=coo)
        if cfg.use_flow and g.n <= cfg.flow_max_n and k <= 16:
            part = R.flow_refine_all_pairs(g, part, k, eps, seed=seed)
        return part

    # -- initial partitioning ----------------------------------------------
    def initial_candidates(self, k: int, eps: float,
                           seed: int) -> List[np.ndarray]:
        g, cfg = self.g, self.cfg

        def refine2(sub: Graph, two: np.ndarray, frac0: float) -> np.ndarray:
            fr = np.asarray([frac0, 1.0 - frac0])
            return R.refine_kway(sub, two, 2, eps, rounds=cfg.refine_rounds,
                                 seed=seed, fractions=fr,
                                 use_kernel=self.use_kernel,
                                 device=self.device)

        fn = refine2 if g.n <= 20000 else None
        return [I.recursive_bisection(g, k, seed=seed + 101 * t, refine_fn=fn)
                for t in range(cfg.initial_tries)]

    # -- objective ---------------------------------------------------------
    def objective(self, part: np.ndarray) -> float:
        return float(edge_cut(self.g, part))

    def imbalance(self, part: np.ndarray, k: int) -> float:
        return balance(self.g, part, k)

    def is_feasible(self, part: np.ndarray, k: int, eps: float) -> bool:
        return is_feasible(self.g, part, k, eps)


def kaffpa(g: Graph, k: int, eps: float = 0.03, preset: str = "eco",
           seed: int = 0, time_limit: float = 0.0,
           input_partition: Optional[np.ndarray] = None,
           enforce_balance: bool = False,
           balance_edges: bool = False, report=None,
           device=None) -> np.ndarray:
    """The ``kaffpa`` program (paper §4.1) on ``device`` (None = CUDA;
    raises without a card unless ``device="cpu"``).

    ``report`` is an optional ``obs.Recorder`` capturing spans, counters
    and the per-cycle quality trajectory of this run."""
    dev = resolve_device(device)
    if balance_edges:
        g = g.with_edge_balanced_weights()
    cfg = PRESETS[preset]
    if k <= 1:
        return np.zeros(g.n, dtype=np.int64)
    medium = GraphMedium(g, cfg, recorder=report, device=dev)
    best = ML.run(medium, k, eps, seed, time_limit=time_limit,
                  input_partition=input_partition)
    if enforce_balance and not is_feasible(g, best, k, eps):
        # the repair reuses the level-0 views of the run
        coo, ell = medium.views
        best = R.refine_kway(g, best, k, eps, rounds=30, seed=seed,
                             force_balance=True, coo=coo, ell=ell,
                             use_kernel=medium.use_kernel)
    return best
