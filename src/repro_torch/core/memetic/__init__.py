"""The memetic engine.

One island loop over any `multilevel.Medium`: kaffpaE / KaBaPE on graphs,
kahyparE on hypergraphs, the memetic separator mode on the 3-label
separator medium.  Children come from the engine's protected-coarsening
``combine`` and V-cycle mutation; migration is a seeded ring exchange of
each island's best partition vector (block exchanges between the ranks
of an ``islands`` mesh, a host roll without one).
"""
from repro_torch.core.memetic.driver import (MemeticConfig, evolve_islands,
                                             island_seed,
                                             validate_memetic_params)
from repro_torch.core.memetic.migrate import (islands_mesh, ring_roll,
                                              ring_roll_host)
from repro_torch.core.memetic.state import (Individual, IslandState,
                                            best_index, worst_index)

__all__ = [
    "Individual", "IslandState", "MemeticConfig",
    "best_index", "worst_index",
    "evolve_islands", "island_seed", "validate_memetic_params",
    "islands_mesh", "ring_roll", "ring_roll_host",
]
