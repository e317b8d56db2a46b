"""Population state for the memetic engine.

An `Individual` is a partition vector plus the scalars the engine ranks
by; an `IslandState` is the whole archipelago.  Ranking is everywhere the
*deterministic* total order ``key() = (fitness, balance, stamp)``: fitness
ties are broken by balance (the better-balanced individual wins — it has
more refinement headroom), and balance ties by the creation stamp (the
deterministic seed that produced the individual), so trajectories never
depend on population insertion order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Individual:
    """One member of an island population.

    ``stamp`` is the deterministic seed that created the individual (initial
    multilevel seed, combine/V-cycle seed, or the source stamp for a
    migrated copy) — it doubles as the final tie-breaker, so the ranking is
    a total order independent of insertion order.  ``feasible`` is the
    medium's feasibility verdict, computed once at creation; replacement
    ranks it first so an infeasible child can never evict a feasible
    incumbent (combine children carry no feasibility guarantee).
    """

    part: np.ndarray
    fitness: float
    balance: float = 0.0
    stamp: int = 0
    feasible: bool = True

    def key(self) -> Tuple[float, float, int]:
        return (self.fitness, self.balance, self.stamp)


def best_index(pop: Sequence[Individual]) -> int:
    return min(range(len(pop)), key=lambda j: pop[j].key())


def worst_index(pop: Sequence[Individual]) -> int:
    return max(range(len(pop)), key=lambda j: pop[j].key())


@dataclasses.dataclass
class IslandState:
    """The archipelago: one population per island plus the generation
    counter the driver reached (wall-clock mode makes it data, not config)."""

    islands: List[List[Individual]]
    generations: int = 0

    @property
    def n_islands(self) -> int:
        return len(self.islands)

    def individuals(self) -> List[Individual]:
        return [ind for pop in self.islands for ind in pop]

    def best(self) -> Individual:
        allind = self.individuals()
        return allind[best_index(allind)]

    def best_part(self) -> np.ndarray:
        """Best feasible individual's partition (any-best fallback when the
        whole archipelago is infeasible) — the kaffpaE final-pick rule.
        Uses the feasibility verdicts cached at creation."""
        allind = self.individuals()
        feas = [i for i in allind if i.feasible]
        pool = feas if feas else allind
        return pool[best_index(pool)].part
