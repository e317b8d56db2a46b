"""Multilevel node-separator subsystem.

First-class separators on the shared multilevel engine: the 3-label
{A, B, S} `SeparatorMedium`, size-constrained separator LP/FM refinement
(the CUDA affinity kernel at k=3 on a card, the COO scatter elsewhere),
the König vertex-cover polish, the ``node_separator`` program entry and
its memetic mode on the island driver.  The post-hoc two-step
construction (core/separator.py) remains as the baseline.
"""
from repro_torch.core.nodesep.driver import (NodesepConfig, PRESETS,
                                             SeparatorMedium,
                                             memetic_node_separator,
                                             memetic_nodesep_labels,
                                             multilevel_node_separator,
                                             nodesep_labels,
                                             nodesep_labels_wave,
                                             split_labels)
from repro_torch.core.nodesep.refine import (SEP, boundary_to_separator,
                                             flow_separator_polish,
                                             refine_separator,
                                             refine_separator_batch,
                                             refine_separator_multi,
                                             sep_affinity_coo,
                                             sep_affinity_ell,
                                             separator_caps,
                                             separator_invariant_ok,
                                             separator_is_feasible,
                                             separator_weight,
                                             vertex_cover_polish)

__all__ = [
    "NodesepConfig", "PRESETS", "SEP", "SeparatorMedium",
    "boundary_to_separator", "flow_separator_polish",
    "memetic_node_separator", "memetic_nodesep_labels",
    "multilevel_node_separator", "nodesep_labels", "nodesep_labels_wave",
    "refine_separator", "refine_separator_batch", "refine_separator_multi",
    "sep_affinity_coo", "sep_affinity_ell", "separator_caps",
    "separator_invariant_ok", "separator_is_feasible", "separator_weight",
    "split_labels", "vertex_cover_polish",
]
