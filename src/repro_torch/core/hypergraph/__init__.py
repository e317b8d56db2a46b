"""Multilevel hypergraph partitioning (`repro_torch.core.hypergraph`).

The hypergraph sibling of the graph pipeline: dual-CSR `Hypergraph`
container with padded ELL/COO torch views, LP-clustering coarsening,
greedy hypergraph growing, size-constrained LP refinement (cut-net and
connectivity objectives, the CUDA pin-count kernel on the hot path), the
`kahypar` multilevel driver, its memetic sibling `kahyparE` and the
distributed `parhyp` on a `core.mesh.Mesh`.
"""
from repro_torch.core.hypergraph.container import (EllHypergraph, Hypergraph,
                                                   HypergraphFormatError,
                                                   PinCoo, to_ell_h,
                                                   to_pincoo)
from repro_torch.core.hypergraph.coarsen import (clique_expansion, contract,
                                                 coarsen_level,
                                                 lp_clustering, project,
                                                 star_expansion)
from repro_torch.core.hypergraph.driver import (
    HypergraphMedium, KahyparConfig, PRESETS, kahypar, kahyparE,
    multilevel_hypergraph_partition)
from repro_torch.core.hypergraph.dist import (PARHYP_PRESETS,
                                              ShardedHypergraph, parhyp,
                                              parhyp_refine,
                                              shard_hypergraph)
from repro_torch.core.hypergraph.initial import (greedy_growing,
                                                 random_partition)
from repro_torch.core.hypergraph.metrics import (balance, block_weights,
                                                 connectivity, cut_net,
                                                 evaluate, is_feasible,
                                                 net_lambdas)
from repro_torch.core.hypergraph.refine import refine_hypergraph

__all__ = [
    "Hypergraph", "HypergraphFormatError", "EllHypergraph", "PinCoo",
    "to_ell_h", "to_pincoo",
    "clique_expansion", "star_expansion", "lp_clustering", "contract",
    "coarsen_level", "project",
    "greedy_growing", "random_partition",
    "balance", "block_weights", "connectivity", "cut_net", "evaluate",
    "is_feasible", "net_lambdas",
    "refine_hypergraph",
    "HypergraphMedium", "KahyparConfig", "PRESETS", "kahypar", "kahyparE",
    "multilevel_hypergraph_partition",
    "PARHYP_PRESETS", "ShardedHypergraph", "parhyp", "parhyp_refine",
    "shard_hypergraph",
]
