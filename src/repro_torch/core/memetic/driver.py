"""The medium-generic memetic island driver.

One island loop serves every incidence medium on the shared multilevel
engine: kaffpaE / KaBaPE on `GraphMedium`, kahyparE on `HypergraphMedium`
(both objectives) and the memetic separator mode on `SeparatorMedium`.
Per generation each island runs tournament selection, produces a child
with the engine's protected-coarsening ``combine`` (or a fresh-seed
V-cycle mutation), the islands' children are refined together in one
batched sweep, an optional variant polish runs (KaBaPE negative cycles),
and each island replaces its worst member under the variant's
replacement rule.  Migration is the seeded ring exchange of
`migrate.ring_roll`.

On a `core.mesh.Mesh` of several ranks every rank runs this whole loop
with the same seeds (the islands' results are replicated) and only the
migration exchanges blocks between ranks; under a wall-clock budget the
ranks agree each generation on whether to go on, so they stop together.

Determinism contract: every stochastic choice island i makes is drawn
from its own RNG stream seeded by ``island_seed(seed, i)``, and every
engine call it issues is seeded from the same stream of stamps — so with
migration disabled the islands evolve *independently* and island i's
trajectory equals a solo run at ``seed + 1009·i`` (pinned by a test).
The sweep row of island i in generation ``gen`` draws from the generator
seeded ``island_seed(seed, i) + STRIDE_SWEEP·gen`` alone, whatever the
batch.  The driver-level RNG is used only for cross-island draws
(quickstart sharing, migration shifts).
"""
from __future__ import annotations

import dataclasses
import numbers
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core import multilevel as ML
from repro_torch.core.mesh import check_mesh
from repro_torch.core.memetic.migrate import ring_roll
from repro_torch.core.memetic.state import Individual, IslandState

STRIDE_ISLAND = 1009
STRIDE_MEMBER = 31
STRIDE_COMBINE = 7919
STRIDE_MUTATE = 104729
STRIDE_SWEEP = 2377


def island_seed(seed: int, isl: int) -> int:
    return seed + STRIDE_ISLAND * isl


def validate_memetic_params(n_islands, population, time_limit,
                            generations=None) -> None:
    """Shared entry-point validation: every memetic driver rejects
    zero/negative island counts and populations (which used to hang or
    index-error deep in the loop) and negative/non-finite time budgets.
    ``time_limit == 0`` stays valid — paper semantics: initial population
    only."""
    if not isinstance(n_islands, numbers.Integral) or n_islands < 1:
        raise ValueError(f"n_islands must be a positive int, got {n_islands!r}")
    if not isinstance(population, numbers.Integral) or population < 1:
        raise ValueError(
            f"population must be a positive int, got {population!r}")
    if (not isinstance(time_limit, numbers.Real)
            or not np.isfinite(float(time_limit)) or float(time_limit) < 0):
        raise ValueError(
            f"time_limit must be a finite number >= 0, got {time_limit!r}")
    if generations is not None and (
            not isinstance(generations, numbers.Integral) or generations < 0):
        raise ValueError(
            f"generations must be None or an int >= 0, got {generations!r}")


@dataclasses.dataclass
class MemeticConfig:
    """Medium-independent knobs of the island loop."""

    n_islands: int = 4
    population: int = 4
    time_limit: float = 10.0
    generations: Optional[int] = None   # deterministic alternative to time
    combine_prob: float = 0.9
    migrate: bool = True
    migration_interval: int = 1
    replacement: str = "worst"          # worst | balanced
    quickstart: bool = False
    batched_generations: bool = True    # one batched sweep for all islands


def _replace_key(cfg: MemeticConfig) -> Callable:
    """Replacement ranks feasibility first under every rule: an infeasible
    child never evicts a feasible incumbent.  Under the default "worst"
    rule the best feasible fitness per island is additionally monotone
    non-increasing — the structural never-worse-than-a-single-run
    guarantee the kaffpaE/kahyparE fronts advertise.  The "balanced" rule
    deliberately trades fitness for balance, so it carries no such
    fitness guarantee."""
    if cfg.replacement == "balanced":
        # KaBaPE rule: within a feasibility class the better-balanced
        # member survives regardless of fitness, so the population
        # converges to strictly balanced partitions
        return lambda ind: (not ind.feasible, ind.balance, ind.fitness,
                            ind.stamp)
    if cfg.replacement != "worst":
        raise ValueError(f"unknown replacement rule {cfg.replacement!r}")
    return lambda ind: (not ind.feasible, ind.fitness, ind.balance,
                        ind.stamp)


def _island_child(medium: ML.Medium, k: int, eps: float, cfg: MemeticConfig,
                  pop: List[Individual], rng: np.random.Generator,
                  iseed: int, gen: int, rec) -> tuple:
    """Produce one island's child for this generation: select then
    combine/mutate.  All randomness comes from the island's own stream.
    Returns (child, stamp)."""
    if rng.random() < cfg.combine_prob and len(pop) >= 2:
        ia, ib = (int(x) for x in rng.choice(len(pop), size=2, replace=False))
        pa = pop[ia] if pop[ia].key() <= pop[ib].key() else pop[ib]
        others = [p for j, p in enumerate(pop) if j not in (ia, ib)]
        pb = min(others, key=Individual.key) if others else pa
        stamp = iseed + STRIDE_COMBINE * gen
        child = ML.combine(medium, pa.part, pb.part, k, eps, stamp)
        rec.count("memetic/combines")
    else:
        src = pop[int(rng.integers(len(pop)))]
        stamp = iseed + STRIDE_MUTATE * gen
        child = ML.vcycle(medium, src.part, k, eps, stamp)
        rec.count("memetic/mutations")
    return child, stamp


def _island_accept(pop: List[Individual], ind: Individual, rkey: Callable,
                   rec) -> None:
    """Replace the island's worst member (under the variant rule) if the
    child is no worse."""
    w = max(range(len(pop)), key=lambda j: rkey(pop[j]))
    if rkey(ind) <= rkey(pop[w]):
        pop[w] = ind
        rec.count("memetic/replacements")


def _sweep_seeds(seed: int, islands: List[int], gen: int) -> List[int]:
    """Per-island sweep row seeds: island i's seed depends only on
    (seed, i, gen), so the batched sweep row equals a solo island's —
    the rows of a batched refine are independent, which keeps the
    independence contract intact."""
    return [island_seed(seed, isl) + STRIDE_SWEEP * gen for isl in islands]


def _generation_sweep(medium: ML.Medium, k: int, eps: float,
                      cfg: MemeticConfig, children: List[np.ndarray],
                      seeds: List[int]) -> List[np.ndarray]:
    """The archipelago's generation step on the device: every island's
    child rides ONE batched refinement call, stepping all islands
    together.  ``batched_generations=False`` issues one call per island
    instead; per-island seeds make the results identical, so the knob is
    purely a performance choice (pinned by a test)."""
    if cfg.batched_generations:
        return medium.refine_batch(children, k, eps, 0, seeds=seeds)
    return [medium.refine_batch([c], k, eps, 0, seeds=seeds[i:i + 1])[0]
            for i, c in enumerate(children)]


def _migration_round(state: IslandState, drv_rng: np.random.Generator,
                     mesh, rkey: Callable) -> None:
    """Ring rumor spreading: each island's best moves ``shift`` islands
    forward; the receiver replaces its worst member — under the variant's
    replacement rule — on strict improvement."""
    n_isl = state.n_islands
    shift = 1 + int(drv_rng.integers(n_isl - 1))
    # the migrant is the best under the replacement rule (feasible members
    # first) — a fitness-only pick could ship an infeasible member that
    # every feasible receiver then rejects, silently disabling migration
    bests = [pop[min(range(len(pop)), key=lambda j: rkey(pop[j]))]
             for pop in state.islands]
    parts = np.stack([b.part for b in bests]).astype(np.int32)
    moved = ring_roll(parts, shift, mesh)
    for i, pop in enumerate(state.islands):
        src = bests[(i - shift) % n_isl]
        inc = Individual(moved[i].astype(np.int64), src.fitness,
                         src.balance, src.stamp, src.feasible)
        w = max(range(len(pop)), key=lambda j: rkey(pop[j]))
        if rkey(inc) < rkey(pop[w]):
            pop[w] = inc


def evolve_islands(medium: ML.Medium, k: int, eps: float,
                   cfg: MemeticConfig, seed: int, *,
                   fitness_fn: Optional[Callable] = None,
                   polish_fn: Optional[Callable] = None,
                   mesh=None,
                   on_generation: Optional[Callable] = None) -> IslandState:
    """Evolve an archipelago of populations over any multilevel medium.

    ``fitness_fn(part)`` defaults to the medium's objective;
    ``polish_fn(part, seed)`` is the variant hook applied to every child
    (the KaBaPE negative-cycle polish, the distributed parhyp polish).
    ``mesh`` (a `core.mesh.Mesh`) lays the islands out over its ranks for
    the migration's block exchange.
    ``cfg.generations`` selects a deterministic generation count; with
    ``None`` the loop runs on the ``time_limit`` wall-clock budget
    (``time_limit == 0`` → initial populations only, paper semantics).
    Returns the final `IslandState`.
    """
    validate_memetic_params(cfg.n_islands, cfg.population, cfg.time_limit,
                            cfg.generations)
    check_mesh(mesh)
    if (not isinstance(cfg.migration_interval, numbers.Integral)
            or cfg.migration_interval < 1):
        raise ValueError(f"migration_interval must be a positive int, "
                         f"got {cfg.migration_interval!r}")
    if not 0.0 <= cfg.combine_prob <= 1.0:
        raise ValueError(
            f"combine_prob must be in [0, 1], got {cfg.combine_prob!r}")
    t0 = time.monotonic()
    fit = fitness_fn if fitness_fn is not None else (
        lambda p: medium.objective(p))

    def make(part, stamp: int) -> Individual:
        part = np.asarray(part, dtype=np.int64)
        return Individual(part, fit(part), medium.imbalance(part, k),
                          stamp, medium.is_feasible(part, k, eps))

    rkey = _replace_key(cfg)
    drv_rng = np.random.default_rng(seed)
    rec = ML.recorder_of(medium)

    pop0 = max(1, cfg.population // 2) if cfg.quickstart else cfg.population
    state = IslandState(islands=[])
    rngs: List[np.random.Generator] = []
    for isl in range(cfg.n_islands):
        iseed = island_seed(seed, isl)
        with rec.span("island_init", island=isl, size=pop0):
            parts = ML.population(medium, k, eps, iseed, pop0,
                                  stride=STRIDE_MEMBER)
        state.islands.append(
            [make(p, iseed + STRIDE_MEMBER * j)
             for j, p in enumerate(parts)])
        rngs.append(np.random.default_rng(iseed))
    if cfg.quickstart:
        # each island created a few; distribute copies among all islands
        # (the pool can be smaller than the draw — sample with replacement
        # then: the copies diverge under combine/mutation)
        every = state.individuals()
        need = cfg.population - pop0
        for pop in state.islands:
            extra = drv_rng.choice(len(every), size=need,
                                   replace=need > len(every))
            pop.extend(dataclasses.replace(every[e],
                                           part=every[e].part.copy())
                       for e in extra)

    def more(gen: int) -> bool:
        if cfg.generations is not None:
            return gen < cfg.generations
        go_on = time.monotonic() - t0 < cfg.time_limit
        return mesh.agree(go_on) if mesh is not None else go_on

    gen = 0
    while more(gen):
        gen += 1
        with rec.span("generation", gen=gen):
            children, stamps = [], []
            for isl in range(cfg.n_islands):
                with rec.span("island_step", island=isl):
                    child, stamp = _island_child(
                        medium, k, eps, cfg, state.islands[isl], rngs[isl],
                        island_seed(seed, isl), gen, rec)
                children.append(child)
                stamps.append(stamp)
            with rec.span("generation_sweep", gen=gen,
                          islands=cfg.n_islands):
                seeds = _sweep_seeds(seed, list(range(cfg.n_islands)), gen)
                children = _generation_sweep(medium, k, eps, cfg,
                                             children, seeds)
            for isl in range(cfg.n_islands):
                child = children[isl]
                if polish_fn is not None:
                    child = polish_fn(child, stamps[isl])
                _island_accept(state.islands[isl], make(child, stamps[isl]),
                               rkey, rec)
            if (cfg.migrate and cfg.n_islands > 1
                    and gen % cfg.migration_interval == 0):
                with rec.span("migration", gen=gen):
                    _migration_round(state, drv_rng, mesh, rkey)
                rec.count("memetic/migrations")
        state.generations = gen
        if rec.enabled:
            best = state.best()
            rec.point("memetic", gen=gen, fitness=best.fitness,
                      balance=best.balance)
        if on_generation is not None:
            on_generation(gen, state.best().fitness)
    return state
