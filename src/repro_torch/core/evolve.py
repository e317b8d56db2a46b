"""KaFFPaE / KaBaPE — the distributed evolutionary partitioner (paper §2.2).

Island model: every island keeps a population of partitions and applies
*combine* and *mutation* operators built from KaFFPa itself.

Combine (the paper's key operator): coarsening is modified so that no cut
edge of either parent is contracted — both parents stay representable at the
coarsest level, the better parent seeds the initial partition, and refinement
(which never worsens) assembles good parts of both.  The shared multilevel
engine implements this medium-generically (core/multilevel.py): clusters are
split by the parents' block signatures before contraction, which
*guarantees* the invariant (DESIGN.md §2/§7).

The island loop itself lives in the medium-generic memetic engine
(core/memetic) — ``kaffpaE`` is the `GraphMedium` front: the MPI
rumor-spreading exchange is the seeded migration ring (block exchanges
between the ranks of an islands mesh), and the KaBaPE
variant rides the same driver with the negative-cycle child polish and
the balanced replacement rule.  One medium serves the whole evolution on
its device, so every restart, combine, V-cycle and KaBaPE polish reuses
its level-0 views.  ``combine`` and ``mutate`` are the operators for one
call outside an evolution: each builds a medium of its own.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.csr import Graph
from repro_torch.core import kaffpa as K
from repro_torch.core import memetic as MEM
from repro_torch.core import multilevel as ML
from repro_torch.core.mesh import device_of
from repro_torch.core.partition import comm_volume, edge_cut
from repro_torch.core.kabape import kabape_refine


def _fitness(g: Graph, part: np.ndarray, k: int,
             optimize_comm_volume: bool) -> float:
    if optimize_comm_volume:
        return float(comm_volume(g, part, k).max())
    return float(edge_cut(g, part))


def combine(g: Graph, pa: np.ndarray, pb: np.ndarray, k: int, eps: float,
            cfg: K.KaffpaConfig, seed: int, device=None) -> np.ndarray:
    """The KaFFPaE combine operator.

    ``pb`` may be *any* domain-specific clustering/partition (the paper
    stresses this flexibility) — only ``pa`` must be a feasible k-partition.
    The offspring never has a worse cut than the better *valid* parent: the
    better one seeds the protected coarsest level and refinement never
    worsens.  Delegates to the shared engine's medium-generic combine.
    """
    return ML.combine(K.GraphMedium(g, cfg, device=device), pa, pb, k, eps,
                      seed)


def mutate(g: Graph, part: np.ndarray, k: int, eps: float,
           cfg: K.KaffpaConfig, seed: int, device=None) -> np.ndarray:
    """Mutation = V-cycle with a fresh seed (paper: KaFFPa provides it)."""
    return ML.vcycle(K.GraphMedium(g, cfg, device=device), part, k, eps,
                     seed)


def kaffpaE(g: Graph, k: int, eps: float = 0.03, preset: str = "fast",
            n_islands: int = 4, population: int = 4,
            time_limit: float = 10.0, seed: int = 0,
            optimize_comm_volume: bool = False,
            enable_kabape: bool = False,
            kabaE_internal_bal: float = 0.01,
            quickstart: bool = False,
            on_generation: Optional[Callable] = None,
            mesh=None, migrate: bool = True,
            generations: Optional[int] = None,
            device=None) -> np.ndarray:
    """The ``kaffpaE`` program (paper §4.2), on the memetic engine, on
    ``device`` (None = CUDA; raises without a card unless
    ``device="cpu"``).

    time_limit == 0 → only the initial population is created (paper
    semantics); ``generations`` selects a deterministic generation count
    instead of the wall-clock budget.  With ``enable_kabape`` offspring get
    the KaBaPE negative-cycle polish at the strict balance constraint and
    replacement evicts infeasible members first.  ``mesh`` (a
    `core.mesh.Mesh`) lays the islands out over its ranks for migration;
    its device is the run's.
    """
    MEM.validate_memetic_params(n_islands, population, time_limit,
                                generations)
    dev = device_of(mesh, device)
    cfg = K.PRESETS[preset]
    if k <= 1:
        return np.zeros(g.n, dtype=np.int64)
    # one medium for the whole evolution: level-0 device views are built
    # once and shared across every multilevel restart / combine / V-cycle
    # and KaBaPE polish
    medium = K.GraphMedium(g, cfg, device=dev)
    fitness_fn = None
    if optimize_comm_volume:
        fitness_fn = lambda p: _fitness(g, p, k, True)        # noqa: E731
    polish_fn = None
    if enable_kabape:
        def polish_fn(p, s):
            coo, ell = medium.views
            return kabape_refine(g, p, k, eps,
                                 internal_bal=kabaE_internal_bal, seed=s,
                                 coo=coo, ell=ell)
    mcfg = MEM.MemeticConfig(
        n_islands=n_islands, population=population, time_limit=time_limit,
        generations=generations, migrate=migrate, quickstart=quickstart,
        replacement="balanced" if enable_kabape else "worst")
    state = MEM.evolve_islands(medium, k, eps, mcfg, seed,
                               fitness_fn=fitness_fn, polish_fn=polish_fn,
                               mesh=mesh, on_generation=on_generation)
    return state.best_part()
