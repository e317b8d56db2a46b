"""The multilevel engine.

One driver serves every incidence medium: build a hierarchy, run an
initial-partition tournament on the coarsest level, uncoarsen with
refinement, optionally iterate cut-protected V-cycles and time-budget
restarts.  The medium-specific pieces (how to cluster, how to contract,
which device views refinement consumes, which objective is optimized) live
behind the `Medium` protocol; `GraphMedium` (core/kaffpa.py) is the graph
adapter.

Device-view ownership: every `Medium` caches its padded device views the
first time refinement needs them, so each hierarchy level builds its views
exactly once and reuses them across refinement rounds, initial-partition
tries, V-cycles and restarts.  The ``engine/view_builds`` counter in the
obs registry instruments this invariant.

Observability: the engine emits hierarchical spans (hierarchy build,
per-level coarsen, the initial tournament, per-level uncoarsen refinement,
V-cycles, restarts), counters, and quality trajectories through the
recorder resolved by `recorder_of` — either the medium's
``EngineParams.recorder`` or the ambient ``obs.use`` context.  With no
recorder installed every hook is the no-op `obs.NULL`; extra objective
evaluations are guarded by ``rec.enabled``.

Protected coarsening (V-cycles §2.1, the memetic combine operator §2.2)
splits every cluster by the block signature of the protected partitions
before contraction, so each protected partition stays exactly
representable at every coarse level.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch import obs


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def recorder_of(medium) -> Any:
    """The recorder engine code should emit to for this medium: the one
    plumbed through ``EngineParams.recorder``, else the ambient ``obs.use``
    recorder (``obs.NULL`` when observability is disabled)."""
    rec = medium.params.recorder
    return rec if rec is not None else obs.current()


def view_build_count() -> int:
    """Total device-view constructions since process start / last reset
    (``obs.metrics.get("engine/view_builds")``)."""
    return int(obs.metrics.get("engine/view_builds"))


def _note_view_build() -> None:
    obs.metrics.inc("engine/view_builds")


def coarsen_stop_n(params, k: int) -> int:
    """Coarsening stop size: keep ~contraction_stop_factor·k nodes, floored
    at stop_n_floor."""
    return max(params.contraction_stop_factor * k, params.stop_n_floor)


class ViewCache:
    """Mixin: lazily build device views once per medium instance.

    A medium lives exactly as long as its hierarchy level, so caching on the
    instance makes view construction O(levels) for a multilevel run, and the
    level-0 views survive across V-cycles and time-budget restarts (the same
    top-level medium object is reused).
    """

    _views: Any = None

    def build_views(self):  # pragma: no cover - overridden by adapters
        raise NotImplementedError

    @property
    def views(self):
        if self._views is None:
            self._views = self.build_views()
            _note_view_build()
        return self._views


# ---------------------------------------------------------------------------
# the Medium protocol
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineParams:
    """The medium-independent knobs the engine loop needs."""

    initial_tries: int = 4
    vcycles: int = 1                    # iterated multilevel cycles
    contraction_stop_factor: int = 40   # stop coarsening at ~factor*k nodes
    cluster_weight_factor: float = 3.0  # max cluster weight = W/(factor*k)
    stop_n_floor: int = 64              # never coarsen below this many nodes
    stall_factor: float = 0.95          # stop when a level shrinks < 5%
    recorder: Any = None                # obs.Recorder; None = ambient/NULL


@runtime_checkable
class Medium(Protocol):
    """What an incidence medium must expose to the multilevel engine.

    Partitions are host int64 arrays of length ``n``; ``cl`` maps are host
    int64 arrays mapping fine ids to coarse ids (projection is always
    ``coarse_part[cl]``, so the engine owns it).
    """

    @property
    def n(self) -> int: ...

    @property
    def params(self) -> EngineParams: ...

    def total_vwgt(self) -> int: ...

    def cluster(self, max_cluster_weight: float, seed: int,
                protect: Optional[Sequence[np.ndarray]] = None) -> np.ndarray:
        """Cluster ids per node (protected cuts should not be merged)."""
        ...

    def contract(self, clusters: np.ndarray) -> tuple["Medium", np.ndarray]:
        """Contract clusters → (coarse medium, fine→coarse map)."""
        ...

    @property
    def views(self) -> Any:
        """Cached device views for refinement (built once per level)."""
        ...

    def refine(self, part: np.ndarray, k: int, eps: float, seed: int,
               force_balance: Optional[bool] = None) -> np.ndarray:
        """Full per-level refinement pipeline; never worsens a feasible
        objective unless forced to restore balance."""
        ...

    def refine_batch(self, parts: Sequence[np.ndarray], k: int, eps: float,
                     seed: int, seeds: Optional[Sequence[int]] = None
                     ) -> List[np.ndarray]:
        """Refine several candidates in one batched device call; ``seeds``
        overrides the per-row generator seeds (the memetic sweep passes
        one per island)."""
        ...

    def polish(self, part: np.ndarray, k: int, eps: float,
               seed: int) -> np.ndarray:
        """Extra single-candidate polish for the tournament winner."""
        ...

    def initial_candidates(self, k: int, eps: float,
                           seed: int) -> List[np.ndarray]:
        """Raw initial partitions for the coarsest-level tournament."""
        ...

    def objective(self, part: np.ndarray) -> float: ...

    def imbalance(self, part: np.ndarray, k: int) -> float:
        """Max block weight over the ideal bound (feasible iff <= 1+eps)."""
        ...

    def is_feasible(self, part: np.ndarray, k: int, eps: float) -> bool: ...


# ---------------------------------------------------------------------------
# hierarchy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Level:
    """One hierarchy level: the medium, the map from the finer level, and
    the protected partitions pushed down to this level (block-constant on
    every cluster by construction)."""

    medium: Medium
    cl: Optional[np.ndarray]                 # None at level 0
    protect: Optional[List[np.ndarray]] = None


def _signature_split(clusters: np.ndarray,
                     protect: Sequence[np.ndarray]) -> np.ndarray:
    """Split clusters by the protected partitions' block signatures, making
    every cluster constant on each protected partition.

    Labels are compressed per partition before mixing, so a protected
    "partition" may be any labelling without signature collisions.
    """
    sig = np.asarray(clusters, dtype=np.int64)
    for p in protect:
        uniq, inv = np.unique(np.asarray(p, dtype=np.int64),
                              return_inverse=True)
        sig = sig * np.int64(len(uniq)) + inv
    return sig


def protect_cut_mask(src: np.ndarray, dst: np.ndarray,
                     protect: Optional[Sequence[np.ndarray]]) -> np.ndarray:
    """Directed-edge mask: True where any protected labelling is cut.

    Shared by the media's ``cluster`` implementations so the protection
    contract lives in one place.
    """
    mask = np.zeros(len(src), dtype=bool)
    for p in protect or ():
        p = np.asarray(p, dtype=np.int64)
        mask |= p[src] != p[dst]
    return mask


def build_hierarchy(medium: Medium, k: int, seed: int,
                    protect: Optional[Sequence[np.ndarray]] = None
                    ) -> List[Level]:
    """Coarsen until ~contraction_stop_factor·k nodes remain.

    With ``protect`` the hierarchy keeps every protected partition exactly
    representable (signature splitting), and the pushed-down copies ride on
    each `Level` so callers can seed the coarsest level from them.
    """
    p = medium.params
    rec = recorder_of(medium)
    cur_protect = list(protect) if protect else None
    levels = [Level(medium, None, cur_protect)]
    cur = medium
    stop_n = coarsen_stop_n(p, k)
    lvl = 0
    with rec.span("hierarchy", n=medium.n, k=k,
                  protected=len(cur_protect or ())):
        while cur.n > stop_n:
            with rec.span("coarsen", level=lvl, n=cur.n):
                max_cw = max(1.0,
                             cur.total_vwgt() / (p.cluster_weight_factor * k))
                clusters = cur.cluster(max_cw, seed + 31 * lvl,
                                       protect=cur_protect)
                if cur_protect:
                    clusters = _signature_split(clusters, cur_protect)
                coarse, cl = cur.contract(clusters)
            if coarse.n >= cur.n * p.stall_factor:
                break
            if cur_protect:
                # clusters are block-constant → scatter projects exactly
                pushed = []
                for part in cur_protect:
                    pc = np.zeros(coarse.n, dtype=np.int64)
                    pc[cl] = part
                    pushed.append(pc)
                cur_protect = pushed
            levels.append(Level(coarse, cl, cur_protect))
            cur = coarse
            lvl += 1
    rec.count("engine/hierarchies")
    rec.count("engine/levels", len(levels))
    return levels


# ---------------------------------------------------------------------------
# initial partitioning: batched tournament on the coarsest level
# ---------------------------------------------------------------------------

def _tournament_pick(medium: Medium, refined: Sequence[np.ndarray], k: int,
                     eps: float, seed: int) -> np.ndarray:
    """Pick the best feasible candidate (best-any fallback) and polish it."""
    rec = recorder_of(medium)
    rec.count("engine/initial_tries", len(refined))
    best, best_obj = None, np.inf
    best_any, best_any_obj = None, np.inf
    for part in refined:
        obj = medium.objective(part)
        if obj < best_any_obj:
            best_any, best_any_obj = part, obj
        if obj < best_obj and medium.is_feasible(part, k, eps):
            best, best_obj = part, obj
    # no feasible candidate: seed from the best objective anyway — the
    # uncoarsening refiners force balance back (tight-eps media hit this)
    if best is None:
        best = best_any
        rec.count("engine/tournament_infeasible")
    if rec.enabled:
        rec.point("initial", n=medium.n,
                  objective=min(best_obj, best_any_obj),
                  feasible=best_obj < np.inf)
    return medium.polish(best, k, eps, seed)


def initial_partition(level: Level, k: int, eps: float, seed: int
                      ) -> np.ndarray:
    """Tournament over ``initial_tries`` candidates.

    All candidates are refined in ONE batched device call (one row per
    candidate); the winner gets the medium's single-candidate polish
    (multi-try / flow on graphs).
    """
    medium = level.medium
    rec = recorder_of(medium)
    with rec.span("initial_tournament", n=medium.n, k=k):
        cands = medium.initial_candidates(k, eps, seed)
        refined = medium.refine_batch(cands, k, eps, seed)
        return _tournament_pick(medium, refined, k, eps, seed)


def initial_partition_wave(levels: Sequence[Level], k: int, eps: float,
                           seeds: Sequence[int]) -> List[np.ndarray]:
    """Tournaments for SEVERAL coarsest levels in batched device calls.

    Sibling subproblems (the nested-dissection wave) usually land in the
    same pow2 shape bucket; levels whose media report the same
    ``bucket_key()`` get their stacked candidate tournaments refined by one
    ``refine_multi`` call instead of one call per subproblem.  Per level
    the result is bit-identical to ``initial_partition`` — rows carry the
    same per-level generator seeds, so batching only changes how many
    launches run them.  Media without bucket_key/refine_multi run per
    level.
    """
    media = [lv.medium for lv in levels]
    if (len(levels) < 2
            or any(not hasattr(m, "bucket_key")
                   or not hasattr(m, "refine_multi") for m in media)):
        return [initial_partition(lv, k, eps, s)
                for lv, s in zip(levels, seeds)]
    cands = [m.initial_candidates(k, eps, s) for m, s in zip(media, seeds)]
    groups: dict = {}
    for i, m in enumerate(media):
        groups.setdefault(m.bucket_key(), []).append(i)
    refined: List[Optional[List[np.ndarray]]] = [None] * len(levels)
    for idx in groups.values():
        if len(idx) == 1:
            i = idx[0]
            refined[i] = media[i].refine_batch(cands[i], k, eps, seeds[i])
        else:
            outs = media[idx[0]].refine_multi(
                [media[i] for i in idx], [cands[i] for i in idx],
                k, eps, [seeds[i] for i in idx])
            for j, i in enumerate(idx):
                refined[i] = outs[j]
    picks = []
    for i, m in enumerate(media):
        with recorder_of(m).span("initial_tournament", n=m.n, k=k):
            picks.append(_tournament_pick(m, refined[i], k, eps, seeds[i]))
    return picks


# ---------------------------------------------------------------------------
# uncoarsening
# ---------------------------------------------------------------------------

def uncoarsen(levels: List[Level], part_coarse: np.ndarray, k: int,
              eps: float, seed: int) -> np.ndarray:
    rec = recorder_of(levels[0].medium)
    part = np.asarray(part_coarse, dtype=np.int64)
    with rec.span("uncoarsen", levels=len(levels)):
        for li in range(len(levels) - 1, 0, -1):
            part = part[levels[li].cl]           # project to the finer level
            fine = levels[li - 1].medium
            with rec.span("refine", level=li - 1, n=fine.n):
                part = fine.refine(part, k, eps, seed + li)
            if rec.enabled:
                rec.point("uncoarsen", level=li - 1, n=fine.n,
                          objective=fine.objective(part))
    return part


def multilevel(medium: Medium, k: int, eps: float, seed: int) -> np.ndarray:
    """One full multilevel cycle: coarsen, tournament, uncoarsen-refine."""
    with recorder_of(medium).span("multilevel", n=medium.n, k=k):
        levels = build_hierarchy(medium, k, seed)
        part_c = initial_partition(levels[-1], k, eps, seed)
        return uncoarsen(levels, part_c, k, eps, seed)


def population(medium: Medium, k: int, eps: float, seed: int, size: int,
               stride: int = 31) -> List[np.ndarray]:
    """Independent multilevel runs at strided seeds — the initial-population
    hook for the memetic island driver.  All runs share the medium's cached
    level-0 device views.

    Each member gets the preset's full V-cycle schedule, exactly as `run`
    applies it — so member j is bit-identical to ``run(medium, k, eps,
    seed + stride*j)`` without a time budget.  That identity (member 0 at
    the base seed == one single run) is what makes the memetic drivers
    structurally never worse than a single run at any preset."""
    ncyc = medium.params.vcycles
    out = []
    with recorder_of(medium).span("population", size=size):
        for j in range(size):
            s = seed + stride * j
            part = multilevel(medium, k, eps, s)
            for cyc in range(1, ncyc):
                part = vcycle(medium, part, k, eps, s + 7919 * cyc)
            out.append(part)
    return out


# ---------------------------------------------------------------------------
# iterated multilevel (V-cycles) and the evolutionary combine operator
# ---------------------------------------------------------------------------

def vcycle(medium: Medium, part: np.ndarray, k: int, eps: float,
           seed: int) -> np.ndarray:
    """Iterated multilevel: re-coarsen protecting the current partition's
    cut, seed the coarsest level with it, refine on the way up.  The result
    is accepted only if it does not worsen the objective (feasibly), so
    quality is non-decreasing across cycles (paper §2.1, Walshaw)."""
    rec = recorder_of(medium)
    part = np.asarray(part, dtype=np.int64)
    with rec.span("vcycle", n=medium.n, k=k):
        levels = build_hierarchy(medium, k, seed, protect=[part])
        coarsest = levels[-1]
        part_c = coarsest.protect[0] if coarsest.protect is not None else part
        part_c = coarsest.medium.refine(part_c, k, eps, seed)
        out = uncoarsen(levels, part_c, k, eps, seed)
        obj_out, obj_in = medium.objective(out), medium.objective(part)
        accepted = obj_out <= obj_in and medium.is_feasible(out, k, eps)
        rec.count("engine/vcycles")
        if rec.enabled:
            rec.point("vcycle", before=obj_in, after=obj_out,
                      accepted=accepted)
        if accepted:
            return out
        rec.count("engine/vcycles_rejected")
        return part


def combine(medium: Medium, pa: np.ndarray, pb: np.ndarray, k: int,
            eps: float, seed: int) -> np.ndarray:
    """The KaFFPaE combine operator (paper §2.2), medium-generic.

    ``pb`` may be *any* domain-specific clustering/partition — only ``pa``
    must be a feasible k-partition.  Both parents' cuts are protected during
    re-coarsening, the better valid parent seeds the coarsest level, and
    refinement (which never worsens) assembles good parts of both.
    """
    rec = recorder_of(medium)
    pa = np.asarray(pa, dtype=np.int64)
    pb = np.asarray(pb, dtype=np.int64)
    with rec.span("combine", n=medium.n, k=k):
        if pb.max() < k and medium.objective(pb) < medium.objective(pa):
            pa, pb = pb, pa          # seed from the better valid parent
        levels = build_hierarchy(medium, k, seed, protect=[pa, pb])
        coarsest = levels[-1]
        part_c = coarsest.protect[0] if coarsest.protect is not None else pa
        part_c = coarsest.medium.refine(part_c, k, eps, seed)
        rec.count("engine/combines")
        return uncoarsen(levels, part_c, k, eps, seed)


# ---------------------------------------------------------------------------
# the complete driver: cycles + time-budget restarts
# ---------------------------------------------------------------------------

def run(medium: Medium, k: int, eps: float, seed: int,
        vcycles: Optional[int] = None, time_limit: float = 0.0,
        input_partition: Optional[np.ndarray] = None) -> np.ndarray:
    """The shared program driver: multilevel (or refine an input partition),
    then iterated V-cycles, then repeated multilevel restarts under a time
    budget (paper ``--time_limit``), keeping the best feasible result."""
    if k <= 1:
        return np.zeros(medium.n, dtype=np.int64)
    rec = recorder_of(medium)
    t0 = time.monotonic()
    with rec.span("run", n=medium.n, k=k, eps=eps):
        if input_partition is not None:
            best = np.asarray(input_partition, dtype=np.int64)
            best = medium.refine(best, k, eps, seed)
        else:
            best = multilevel(medium, k, eps, seed)
        if rec.enabled:
            rec.point("cycles", cycle=0, objective=medium.objective(best),
                      imbalance=medium.imbalance(best, k))
        ncyc = medium.params.vcycles if vcycles is None else vcycles
        for cyc in range(1, ncyc):
            best = vcycle(medium, best, k, eps, seed + 7919 * cyc)
            if rec.enabled:
                rec.point("cycles", cycle=cyc,
                          objective=medium.objective(best),
                          imbalance=medium.imbalance(best, k))
        trial = 1
        while time_limit > 0 and time.monotonic() - t0 < time_limit:
            with rec.span("restart", trial=trial):
                cand = multilevel(medium, k, eps, seed + 104729 * trial)
            rec.count("engine/restarts")
            if (medium.objective(cand) < medium.objective(best)
                    and medium.is_feasible(cand, k, eps)):
                best = cand
            if rec.enabled:
                rec.point("restarts", trial=trial,
                          objective=medium.objective(best))
            trial += 1
    return best
