"""Partition metrics — the ``evaluator`` / ``toolbox`` functionality.

Objectives from the paper §1:
  * edge cut           ω(E ∩ ⋃_{i<j} V_i × V_j)
  * balance            max_i c(V_i) / ⌈c(V)/k⌉  must be ≤ 1+ε
  * max communication volume: for block B, sum over v∈B of #distinct other
    blocks adjacent to v.

Host versions work on numpy; the device versions work on a `CooGraph` and
torch labels of length n_pad, optionally with a leading batch dim.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.csr import Graph, CooGraph


# -- host ---------------------------------------------------------------------

def edge_cut(g: Graph, part: np.ndarray) -> int:
    src = g.edge_sources()
    cut2 = g.adjwgt[part[src] != part[g.adjncy]].sum()
    return int(cut2) // 2


def block_weights(g: Graph, part: np.ndarray, k: int) -> np.ndarray:
    bw = np.zeros(k, dtype=np.int64)
    np.add.at(bw, part, g.vwgt)
    return bw


def balance(g: Graph, part: np.ndarray, k: int) -> float:
    """max block weight / ceil(total/k); feasible iff <= 1+eps."""
    bw = block_weights(g, part, k)
    lmax = int(np.ceil(g.total_vwgt() / k))
    return float(bw.max()) / max(lmax, 1)


def is_feasible(g: Graph, part: np.ndarray, k: int, eps: float) -> bool:
    return balance(g, part, k) <= 1.0 + eps + 1e-9


def boundary_nodes(g: Graph, part: np.ndarray) -> np.ndarray:
    src = g.edge_sources()
    cutedge = part[src] != part[g.adjncy]
    mask = np.zeros(g.n, dtype=bool)
    mask[src[cutedge]] = True
    return np.flatnonzero(mask)


def comm_volume(g: Graph, part: np.ndarray, k: int) -> np.ndarray:
    """Per-block communication volume; objective = max over blocks."""
    src = g.edge_sources()
    other = part[g.adjncy]
    mine = part[src]
    ext = mine != other
    # distinct (v, other_block) pairs
    key = src[ext] * np.int64(k) + other[ext]
    uniq_v = np.unique(key) // k
    vol = np.zeros(k, dtype=np.int64)
    np.add.at(vol, part[uniq_v.astype(np.int64)], 1)
    return vol


def evaluate(g: Graph, part: np.ndarray, k: int, eps: float = 0.03) -> dict:
    """The ``evaluator`` report."""
    bw = block_weights(g, part, k)
    return {
        "k": k,
        "cut": edge_cut(g, part),
        "balance": balance(g, part, k),
        "feasible": is_feasible(g, part, k, eps),
        "max_block": int(bw.max()),
        "min_block": int(bw.min()),
        "boundary_nodes": int(len(boundary_nodes(g, part))),
        "max_comm_volume": int(comm_volume(g, part, k).max()) if k > 1 else 0,
    }


def edge_partition_metrics(g: Graph, edge_part: np.ndarray, k: int) -> dict:
    """Edge-partition quality: vertex replication factor (paper §2.7).

    edge_part[j] is the block of undirected edge j (edges in from_edges
    canonical lo<hi order).
    """
    src = g.edge_sources()
    fwd = src < g.adjncy
    u, v = src[fwd], g.adjncy[fwd]
    reps = np.unique(np.stack([np.concatenate([u, v]),
                               np.concatenate([edge_part, edge_part])], 1),
                     axis=0)
    counts = np.bincount(reps[:, 0], minlength=g.n)
    sizes = np.bincount(edge_part, minlength=k)
    return {
        "replication": float(counts.sum()) / max(g.n, 1),
        "max_block_edges": int(sizes.max()),
        "balance": float(sizes.max()) / max(int(np.ceil(len(u) / k)), 1),
    }


# -- device -------------------------------------------------------------------

def edge_cut_device(g: CooGraph, labels: torch.Tensor) -> torch.Tensor:
    """Cut weight (counts each undirected edge once: COO stores both dirs).

    ``labels`` is (n_pad,) or (B, n_pad); padding edges carry w == 0 and
    are inert.  Weights are integers in f32 and the total stays below
    2^24, so the sum is exact in any order.
    """
    cut = labels[..., g.src_long] != labels[..., g.dst_long]
    return torch.where(cut, g.w, 0.0).sum(-1) * 0.5


def block_weights_device(g: CooGraph, labels: torch.Tensor,
                         k: int) -> torch.Tensor:
    """(k,) block weights of (n_pad,) labels (exact: integer weights)."""
    return torch.zeros(k, dtype=g.vwgt.dtype, device=g.device).index_add_(
        0, labels.long(), g.vwgt)
