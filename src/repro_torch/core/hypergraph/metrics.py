"""Hypergraph partition metrics — cut-net, connectivity (λ−1), balance.

Objectives (KaHyPar line of work):
  * cut-net        Σ_{e cut} w(e)                    (net spans ≥ 2 blocks)
  * connectivity   Σ_e w(e)·(λ(e) − 1)               (λ = #blocks e touches)
  * balance        max_i c(V_i) / ⌈c(V)/k⌉  must be ≤ 1+ε

Both host (numpy) and device (torch) versions are provided; the device
versions take a leading batch dim and operate on the padded (B, e_pad, k)
pin-count tensor that the refinement loop already materialises each round.
Counts, λ and weights are integers in f32: the device sums stay exact in
any order (the unordered atomics of CUDA's ``scatter_add_`` included)
while totals stay below 2^24 — at the kahypar main path (rmat_hypergraph
(17), 707,640 pins) the λ−1 total is at most ~10^6.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hypergraph.container import Hypergraph, PinCoo


# -- host ---------------------------------------------------------------------

def net_lambdas(hg: Hypergraph, part: np.ndarray) -> np.ndarray:
    """λ(e) = number of distinct blocks net e touches.  (m,)"""
    part = np.asarray(part, dtype=np.int64)
    pe = hg.pin_sources()
    k = int(part.max()) + 1 if len(part) else 1
    key = np.unique(pe * np.int64(k) + part[hg.eind])
    lam = np.zeros(hg.m, dtype=np.int64)
    np.add.at(lam, key // k, 1)
    return lam


def cut_net(hg: Hypergraph, part: np.ndarray) -> int:
    lam = net_lambdas(hg, part)
    return int(hg.ewgt[lam >= 2].sum())


def connectivity(hg: Hypergraph, part: np.ndarray) -> int:
    """The (λ−1) objective — communication volume of the data placement."""
    lam = net_lambdas(hg, part)
    return int((hg.ewgt * np.maximum(lam - 1, 0)).sum())


def block_weights(hg: Hypergraph, part: np.ndarray, k: int) -> np.ndarray:
    bw = np.zeros(k, dtype=np.int64)
    np.add.at(bw, np.asarray(part, dtype=np.int64), hg.vwgt)
    return bw


def balance(hg: Hypergraph, part: np.ndarray, k: int) -> float:
    bw = block_weights(hg, part, k)
    lmax = int(np.ceil(hg.total_vwgt() / k))
    return float(bw.max()) / max(lmax, 1)


def is_feasible(hg: Hypergraph, part: np.ndarray, k: int,
                eps: float) -> bool:
    return balance(hg, part, k) <= 1.0 + eps + 1e-9


def evaluate(hg: Hypergraph, part: np.ndarray, k: int,
             eps: float = 0.03) -> dict:
    """The evaluator report for hypergraph partitions."""
    bw = block_weights(hg, part, k)
    return {
        "k": k,
        "cut_net": cut_net(hg, part),
        "km1": connectivity(hg, part),
        "balance": balance(hg, part, k),
        "feasible": is_feasible(hg, part, k, eps),
        "max_block": int(bw.max()),
        "min_block": int(bw.min()),
    }


# -- device -------------------------------------------------------------------

def pin_counts_device(hc: PinCoo, labels: torch.Tensor,
                      k: int) -> torch.Tensor:
    """cnt[b, e, c] = #pins of net e with label c.  ``labels`` (B, n_pad)
    with values in [0, k) → (B, e_pad, k)."""
    idx = hc.pe_long * k + labels[:, hc.pv_long].long()       # (B, p_pad)
    cnt = torch.zeros(labels.shape[0], hc.e_pad * k, dtype=torch.float32,
                      device=labels.device)
    cnt.scatter_add_(1, idx, hc.mask.expand_as(idx))
    return cnt.view(labels.shape[0], hc.e_pad, k)


def km1_device(cnt: torch.Tensor, netw: torch.Tensor) -> torch.Tensor:
    """(B,) Σ w(e)·(λ(e)−1) from (B, e_pad, k) pin counts; padding nets
    carry netw == 0."""
    lam = (cnt > 0).to(torch.float32).sum(-1)
    return (netw * torch.clamp(lam - 1.0, min=0.0)).sum(-1)


def cut_net_device(cnt: torch.Tensor, netw: torch.Tensor) -> torch.Tensor:
    """(B,) Σ w(e)·[λ(e) ≥ 2] from (B, e_pad, k) pin counts."""
    lam = (cnt > 0).to(torch.float32).sum(-1)
    return torch.where(lam >= 2.0, netw, 0.0).sum(-1)
