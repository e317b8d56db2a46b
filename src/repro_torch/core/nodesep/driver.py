"""Multilevel node separators — the `SeparatorMedium` adapter and the
``node_separator`` (multilevel) program entry.

The paper's node-separator tool was a post-hoc construction (partition with
KaFFPa, then vertex-cover the boundary — core/separator.py, kept as the
baseline).  This medium makes separators first-class on the shared engine
(core/multilevel.py): the 3-label state {A, B, S} rides the same hierarchy
build, batched initial tournament, uncoarsen-refine, V-cycles and
time-budget restarts, but every refinement step optimizes the *separator
weight* directly (arXiv:1012.0006: local search on the target objective at
every level is where the quality comes from).

Coarsening is label-oblivious on the way down (no labels exist yet); on
protected re-coarsening (V-cycles) the engine's signature splitting keeps
the 3-label state exactly representable, which in particular never
contracts an A–B pair — the separator stays a separator at every level,
and projected labels stay feasible because cluster weights are label-sums.

A medium holds its device (None = CUDA): every view, generator and
refinement of the run lands there.  Its views — COO, and on the kernel
path the ELL with the separator-gain slot weights (``ops.sep_weights``) —
are built once per level and serve the separator scan and the 2-way cut
refinements of the escape candidate and the initial bisections alike.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.csr import Graph, resolve_device, to_coo, to_ell
from repro_torch.core import coarsen as C
from repro_torch.core import initial as I
from repro_torch.core import multilevel as ML
from repro_torch.core import refine as R
from repro_torch.core.mesh import device_of
from repro_torch.core.nodesep.refine import (SEP, boundary_to_separator,
                                             flow_separator_polish,
                                             refine_separator,
                                             refine_separator_batch,
                                             refine_separator_multi,
                                             separator_invariant_ok,
                                             separator_is_feasible,
                                             separator_weight,
                                             vertex_cover_polish)
from repro_torch.core.partition import is_feasible


@dataclasses.dataclass
class NodesepConfig:
    coarsening: str = "matching"        # matching | lp
    lp_iters: int = 8
    refine_rounds: int = 10
    bisect_rounds: int = 8              # 2-way cut rounds (init + cut polish)
    multi_try: int = 0                  # localized cut restarts per level
    initial_tries: int = 4
    vcycles: int = 1
    contraction_stop_factor: int = 40
    cluster_weight_factor: float = 3.0
    stop_n_floor: int = 64
    vc_polish_max_n: int = 6000         # König polish only below this size
    use_flow: bool = True               # band min-vertex-cut polish
    flow_max_n: int = 6000
    flow_band_depth: int = 3
    use_kernel: Optional[bool] = None   # None = CUDA kernel on a card


PRESETS = {
    "fast":         NodesepConfig(refine_rounds=6, bisect_rounds=6,
                                  initial_tries=2),
    "eco":          NodesepConfig(refine_rounds=12, initial_tries=4,
                                  multi_try=2),
    "strong":       NodesepConfig(refine_rounds=16, initial_tries=6,
                                  multi_try=3, vcycles=2),
    "fastsocial":   NodesepConfig(coarsening="lp", refine_rounds=6,
                                  bisect_rounds=6, initial_tries=2),
    "ecosocial":    NodesepConfig(coarsening="lp", refine_rounds=12,
                                  initial_tries=4, multi_try=2),
    "strongsocial": NodesepConfig(coarsening="lp", refine_rounds=16,
                                  initial_tries=6, multi_try=3, vcycles=2),
}


class SeparatorMedium(ML.ViewCache):
    """The node-separator adapter for the shared multilevel engine.

    Partitions handled by the engine are 3-label arrays {0=A, 1=B, 2=S};
    ``k`` is always 2 (two blocks — S is the objective, not a block).
    ``recorder`` and ``device`` (None = CUDA, which must be present)
    survive contraction, as in `GraphMedium`."""

    def __init__(self, g: Graph, cfg: NodesepConfig, recorder=None,
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
            # forbids contracting any label-mixed pair — A–B in particular
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
        return SeparatorMedium(coarse, self.cfg, recorder=self.recorder,
                               device=self.device), cl

    # -- device views ------------------------------------------------------
    def build_views(self):
        """(coo, ell, vw_nbr): ``ell`` and its separator-gain slot weights
        ``vw_nbr`` only on the kernel path (else None)."""
        coo = to_coo(self.g, device=self.device)
        if not self.use_kernel:
            return coo, None, None
        from repro_torch.kernels import ops as kops
        ell = to_ell(self.g, row_tile=coo.n_pad, device=self.device)
        return coo, ell, kops.sep_weights(ell.nbr, ell.wgt, ell.vwgt)

    def _refine_sep(self, part, eps, seed, force_balance=False):
        coo, ell, vw_nbr = self.views
        return refine_separator(self.g, part, eps,
                                rounds=self.cfg.refine_rounds, seed=seed,
                                coo=coo, ell=ell, vw_nbr=vw_nbr,
                                use_kernel=self.use_kernel,
                                force_balance=force_balance)

    def _refine_cut(self, two, eps, seed, force_balance=False):
        """2-way cut refinement on the level's cached views."""
        coo, ell, _ = self.views
        return R.refine_kway(self.g, two, 2, eps,
                             rounds=self.cfg.bisect_rounds, seed=seed,
                             coo=coo, ell=ell, use_kernel=self.use_kernel,
                             force_balance=force_balance)

    # -- refinement --------------------------------------------------------
    def refine(self, part: np.ndarray, k: int, eps: float, seed: int,
               force_balance: Optional[bool] = None) -> np.ndarray:
        rec = ML.recorder_of(self)
        if force_balance is None:
            force_balance = not separator_is_feasible(self.g, part, eps)
        part = self._refine_sep(part, eps, seed, force_balance)
        if rec.enabled:
            rec.count("refine/rounds", self.cfg.refine_rounds)
            if force_balance:
                rec.count("refine/forced_balance")
        part = self.polish(part, k, eps, seed)
        cand = self._cut_candidate(part, eps, seed)
        if (separator_weight(self.g, cand) < separator_weight(self.g, part)
                and separator_is_feasible(self.g, cand, eps)):
            part = cand
            rec.count("nodesep/cut_escapes_adopted")
        return part

    def _cut_candidate(self, part: np.ndarray, eps: float,
                       seed: int) -> np.ndarray:
        """Edge-cut-driven escape candidate: reabsorb S into the bipartition
        by side affinity, refine the *cut* (the post-hoc baseline's per-level
        step), lift the boundary back into S, separator-refine and
        VC-polish.  The caller adopts it only on improvement, so `refine`
        stays non-worsening — but comparing *fully polished* candidates is
        what lets a better-cut basin win even when its raw boundary is
        heavier than the incumbent separator."""
        g = self.g
        coo = self.views[0]
        part = np.asarray(part, dtype=np.int64)
        src = g.edge_sources()
        aff = np.zeros((g.n, 2), dtype=np.int64)
        for b in (0, 1):
            m = part[g.adjncy] == b
            np.add.at(aff[:, b], src[m], g.adjwgt[m])
        two = np.where(part == SEP, (aff[:, 1] > aff[:, 0]).astype(np.int64),
                       part)
        two = self._refine_cut(two, eps, seed + 7,
                               force_balance=not is_feasible(g, two, 2, eps))
        if self.cfg.multi_try:
            two = R.multi_try_refine(g, two, 2, eps,
                                     tries=self.cfg.multi_try,
                                     rounds=self.cfg.bisect_rounds,
                                     seed=seed + 11, coo=coo)
        cand = self._refine_sep(boundary_to_separator(g, two), eps, seed + 13)
        return self.polish(cand, 2, eps, seed)

    def refine_batch(self, parts: Sequence[np.ndarray], k: int, eps: float,
                     seed: int, seeds: Optional[Sequence[int]] = None
                     ) -> List[np.ndarray]:
        coo, ell, vw_nbr = self.views
        return refine_separator_batch(self.g, list(parts), eps,
                                      rounds=self.cfg.refine_rounds,
                                      seed=seed, coo=coo, ell=ell,
                                      vw_nbr=vw_nbr,
                                      use_kernel=self.use_kernel,
                                      seeds=seeds)

    def bucket_key(self):
        """Shape-bucket identity for the ND wave: media agreeing on this
        key share one batched tournament call."""
        coo = self.views[0]
        return ("sep", coo.n_pad, coo.e_pad, self.cfg.refine_rounds,
                self.use_kernel)

    def refine_multi(self, media: Sequence["SeparatorMedium"],
                     cands_lists: Sequence[Sequence[np.ndarray]], k: int,
                     eps: float, seeds: Sequence[int]
                     ) -> List[List[np.ndarray]]:
        """Cross-graph batched tournament refine for same-bucket siblings
        (invoked via `ML.initial_partition_wave`)."""
        return refine_separator_multi([m.g for m in media],
                                      [list(c) for c in cands_lists], eps,
                                      rounds=self.cfg.refine_rounds,
                                      seeds=list(seeds),
                                      coos=[m.views[0] for m in media])

    def polish(self, part: np.ndarray, k: int, eps: float,
               seed: int) -> np.ndarray:
        rec = ML.recorder_of(self)
        if self.g.n <= self.cfg.vc_polish_max_n:
            part = vertex_cover_polish(self.g, part, eps)
            rec.count("nodesep/vc_polish")
        if self.cfg.use_flow and self.g.n <= self.cfg.flow_max_n:
            part = flow_separator_polish(self.g, part, eps,
                                         band_depth=self.cfg.flow_band_depth)
            rec.count("nodesep/flow_polish")
        return part

    # -- initial partitioning ----------------------------------------------
    def initial_candidates(self, k: int, eps: float,
                           seed: int) -> List[np.ndarray]:
        """Bisect (greedy growing + 2-way gain refinement on the cached
        views), then lift the lighter boundary side into S.  The engine's
        tournament separator-refines all candidates in one batched call."""
        cands = []
        for t in range(self.cfg.initial_tries):
            two = I.bfs_grow_bisection(self.g, 0.5, seed=seed + 101 * t)
            two = self._refine_cut(two, eps, seed + 101 * t)
            cands.append(boundary_to_separator(self.g, two))
        return cands

    # -- objective ---------------------------------------------------------
    def objective(self, part: np.ndarray) -> float:
        return float(separator_weight(self.g, part))

    def imbalance(self, part: np.ndarray, k: int) -> float:
        labels = np.asarray(part)
        wa = int(self.g.vwgt[labels == 0].sum())
        wb = int(self.g.vwgt[labels == 1].sum())
        lmax = np.ceil(self.g.total_vwgt() / 2.0)
        return float(max(wa, wb)) / max(lmax, 1.0)

    def is_feasible(self, part: np.ndarray, k: int, eps: float) -> bool:
        return (separator_is_feasible(self.g, part, eps)
                and separator_invariant_ok(self.g, part))


# ---------------------------------------------------------------------------
# program entries
# ---------------------------------------------------------------------------

def split_labels(labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """3-label state → (separator ids, underlying bipartition).

    S vertices get block 0 in the bipartition — callers mask them out via
    the separator ids (matching the post-hoc ``node_separator`` contract)."""
    labels = np.asarray(labels, dtype=np.int64)
    sep = np.flatnonzero(labels == SEP)
    part2 = np.where(labels == 1, 1, 0).astype(np.int64)
    return sep, part2


def multilevel_node_separator(g: Graph, eps: float = 0.20,
                              preset: str = "eco", seed: int = 0,
                              vcycles: Optional[int] = None,
                              time_limit: float = 0.0, report=None,
                              device=None) -> Tuple[np.ndarray, np.ndarray]:
    """The multilevel ``node_separator`` program (2-way) on ``device``
    (None = CUDA; raises without a card unless ``device="cpu"``).

    Returns (separator_ids, part2) like the post-hoc baseline
    (core/separator.py), but optimizes separator weight at every hierarchy
    level through the shared engine.
    """
    return split_labels(nodesep_labels(g, eps, preset, seed,
                                       vcycles=vcycles,
                                       time_limit=time_limit,
                                       report=report, device=device))


def nodesep_labels(g: Graph, eps: float = 0.20, preset: str = "eco",
                   seed: int = 0, vcycles: Optional[int] = None,
                   time_limit: float = 0.0, report=None,
                   device=None) -> np.ndarray:
    """Raw 3-label output of the multilevel separator driver.

    ``report`` is an optional ``obs.Recorder``."""
    dev = resolve_device(device)
    if g.n == 0:
        return np.zeros(0, dtype=np.int64)
    medium = SeparatorMedium(g, PRESETS[preset], recorder=report, device=dev)
    return ML.run(medium, 2, eps, seed, vcycles=vcycles,
                  time_limit=time_limit)


def nodesep_labels_wave(graphs: Sequence[Graph], eps: float = 0.20,
                        preset: str = "eco",
                        seeds: Optional[Sequence[int]] = None,
                        report=None, device=None) -> List[np.ndarray]:
    """3-label separators for SEVERAL graphs, batching across siblings.

    The nested-dissection recursion (core/ordering.py) calls this on waves
    of sibling subproblems: hierarchies are built per graph, then the
    coarsest-level tournaments of same-shape-bucket siblings run as one
    batched device call (`ML.initial_partition_wave`).  Per graph the
    result is bit-identical to ``nodesep_labels(graphs[i], eps, preset,
    seed=seeds[i])`` without a time budget.
    """
    dev = resolve_device(device)
    seeds = list(seeds) if seeds is not None else [0] * len(graphs)
    cfg = PRESETS[preset]
    results: List[Optional[np.ndarray]] = [None] * len(graphs)
    hier = []
    for i, g in enumerate(graphs):
        if g.n == 0:
            results[i] = np.zeros(0, dtype=np.int64)
            continue
        m = SeparatorMedium(g, cfg, recorder=report, device=dev)
        hier.append((i, m, ML.build_hierarchy(m, 2, seeds[i])))
    parts_c = ML.initial_partition_wave([lv[-1] for _, _, lv in hier], 2,
                                        eps, [seeds[i] for i, _, _ in hier])
    for (i, m, lv), pc in zip(hier, parts_c):
        part = ML.uncoarsen(lv, pc, 2, eps, seeds[i])
        for cyc in range(1, m.params.vcycles):
            part = ML.vcycle(m, part, 2, eps, seeds[i] + 7919 * cyc)
        results[i] = part
    return results


def memetic_nodesep_labels(g: Graph, eps: float = 0.20, preset: str = "eco",
                           seed: int = 0, n_islands: int = 2,
                           population: int = 2, time_limit: float = 5.0,
                           generations: Optional[int] = None,
                           migrate: bool = True, mesh=None, report=None,
                           device=None) -> np.ndarray:
    """Memetic separator mode: the island driver over `SeparatorMedium` on
    ``device`` (None = CUDA; raises without a card unless
    ``device="cpu"``) — the engine's protected-coarsening combine keeps
    both parents' 3-label states representable, so offspring separators
    are never heavier than the seeding parent.  ``mesh`` (a
    `core.mesh.Mesh`) lays the islands out over its ranks for migration;
    its device is the run's."""
    from repro_torch.core import memetic as MEM
    MEM.validate_memetic_params(n_islands, population, time_limit,
                                generations)
    dev = device_of(mesh, device)
    if g.n == 0:
        return np.zeros(0, dtype=np.int64)
    medium = SeparatorMedium(g, PRESETS[preset], recorder=report, device=dev)
    cfg = MEM.MemeticConfig(n_islands=n_islands, population=population,
                            time_limit=time_limit, generations=generations,
                            migrate=migrate)
    state = MEM.evolve_islands(medium, 2, eps, cfg, seed, mesh=mesh)
    return state.best_part()


def memetic_node_separator(g: Graph, eps: float = 0.20, preset: str = "eco",
                           seed: int = 0, n_islands: int = 2,
                           population: int = 2, time_limit: float = 5.0,
                           generations: Optional[int] = None,
                           migrate: bool = True, mesh=None, report=None,
                           device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Memetic ``node_separator`` (2-way): (separator_ids, part2)."""
    return split_labels(memetic_nodesep_labels(
        g, eps, preset, seed, n_islands=n_islands, population=population,
        time_limit=time_limit, generations=generations, migrate=migrate,
        mesh=mesh, report=report, device=device))
