"""Device topology ↔ KaHIP process mapping (the paper's §2.6 applied to
the model framework's device meshes).

A train step's collective traffic is summarized as a communication matrix
over *logical mesh axes*; the physical system is a hierarchy of links
(for example: devices of one host, hosts of one switch, switches).
KaHIP's multisection mapping then decides which logical axis lands on
which physical level — i.e. the axis order of the device mesh — by
minimizing the QAP objective with the per-level distances.  The default
distances 1 / 10 / 100 charge each level ten times its inner one.

Host numpy throughout: the mapping's matrices are (k, k) with k the
device count; its partitioning calls run on ``device`` (None = CUDA).
"""
from __future__ import annotations

import itertools
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.mapping import (processor_distance_matrix, qap_cost,
                                      process_mapping)


def collective_traffic_by_axis(collective_bytes: Dict[str, float],
                               axis_sizes: Dict[str, int]) -> Dict[str, float]:
    """Per-mesh-axis bytes from a parsed collective table (bytes keyed by
    the axes each collective runs over)."""
    return {a: collective_bytes.get(a, 0.0) for a in axis_sizes}


def axis_comm_matrix(device_pairs_bytes: np.ndarray) -> np.ndarray:
    return device_pairs_bytes


def build_device_comm_matrix(axis_bytes: Dict[str, float],
                             axis_sizes: Dict[str, int]) -> np.ndarray:
    """Expand per-axis collective bytes into a device×device communication
    matrix: a collective over axis a moves bytes between devices that differ
    only in their coordinate on a (ring neighbours for all-reduce)."""
    names = list(axis_sizes)
    sizes = [axis_sizes[n] for n in names]
    k = int(np.prod(sizes))
    comm = np.zeros((k, k))
    coords = list(itertools.product(*[range(s) for s in sizes]))
    index = {c: i for i, c in enumerate(coords)}
    for ai, a in enumerate(names):
        per_link = axis_bytes.get(a, 0.0) / max(k, 1)
        if per_link <= 0:
            continue
        for c in coords:
            nxt = list(c)
            nxt[ai] = (nxt[ai] + 1) % sizes[ai]
            i, j = index[c], index[tuple(nxt)]
            comm[i, j] += per_link
            comm[j, i] += per_link
    return comm


def choose_axis_assignment(axis_bytes: Dict[str, float],
                           axis_sizes: Dict[str, int],
                           hierarchy: Sequence[int] = (16, 16, 2),
                           distances: Sequence[int] = (1, 10, 100),
                           seed: int = 0, device=None) -> dict:
    """Run the paper's mapping on the step's communication structure.

    Returns dict(mapping=…, qap=…, identity_qap=…, improvement=…).
    The identity mapping corresponds to the naive axis order; the returned
    mapping is what launch scripts should use to permute device ids.
    """
    comm = build_device_comm_matrix(axis_bytes, axis_sizes)
    k = comm.shape[0]
    if k != int(np.prod(hierarchy)):
        raise ValueError(f"{k} devices do not fill the hierarchy "
                         f"{list(hierarchy)}")
    dist = processor_distance_matrix(list(hierarchy), list(distances))
    identity = np.arange(k)
    id_cost = qap_cost(comm.astype(np.int64), dist, identity)
    mapping = process_mapping(comm.astype(np.int64), list(hierarchy),
                              list(distances), seed=seed, device=device)
    m_cost = qap_cost(comm.astype(np.int64), dist, mapping)
    return {
        "mapping": mapping,
        "qap": int(m_cost),
        "identity_qap": int(id_cost),
        "improvement": 0.0 if id_cost == 0 else 1.0 - m_cost / id_cost,
    }
