"""Size-constrained label propagation (paper §2.4 / §4.10) — device side.

The batch-synchronous formulation of KaHIP's LP: per round every node
computes its affinity to every candidate label in parallel, then a
conflict-free subset of moves is applied with a hard size guarantee
("capped acceptance").

Two regimes:
  * clustering  — labels range over [0, n_pad) (coarsening;
    ``label_propagation`` program).  Affinity via lexsort+segment over edges.
  * k-way       — labels range over [0, k), k small (refinement).  Affinity
    is a dense (B, n_pad, k) histogram == A @ onehot(labels); the CUDA
    kernel (kernels/csrc/lp_affinity.cu) computes it on the ELL layout, the
    COO scatter here is the plain path.

The k-way functions take a leading batch dim B (one row per candidate
partition).  Random tie-break noise comes in as an argument: a tensor of
draws (the tests hand in the JAX package's draws) or torch.Generators,
one per batch row, so a row never depends on the batch it rides in.

Every value the scatters here add (vertex and edge weights, sizes, cuts)
is an integer in f32 below 2^24, so the sums are exact in any order — the
unordered atomics of CUDA's ``index_add_``/``scatter_add_`` included.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.csr import CooGraph, Graph, resolve_device, to_coo

_NEG = -1e30
_NOISE = 1e-4          # random tie-break amplitude
_GAIN_EPS = 1e-3       # strictly-positive-gain threshold (> noise)

#: Per-round tie-break noise: a tensor of draws, or generators to draw from.
Noise = Union[torch.Tensor, Sequence[torch.Generator], torch.Generator]


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort`` along the last dim: the last key is primary, ties
    fall to the earlier keys and then to position.  Built from stable
    sorts, least significant key first."""
    order = None
    for key in keys:
        k = key if order is None else key.gather(-1, order)
        idx = torch.sort(k, dim=-1, stable=True).indices
        order = idx if order is None else order.gather(-1, idx)
    return order


def uniform_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform [0, _NOISE) tie-break draws from one generator."""
    return torch.rand(shape, generator=gen, device=device) * _NOISE


# ---------------------------------------------------------------------------
# capped acceptance: apply proposed moves without exceeding target capacity
# ---------------------------------------------------------------------------

def capped_accept(labels: torch.Tensor, proposal: torch.Tensor,
                  vwgt: torch.Tensor, sizes: torch.Tensor, cap: torch.Tensor,
                  priority: torch.Tensor) -> torch.Tensor:
    """Accept moves in priority order (desc) per target until capacity.

    ``labels``/``proposal``/``priority`` are (B, n), ``sizes`` (B, c),
    ``vwgt`` (n,) or (B, n), and ``cap`` (c,), shared by every row, or
    (B, c), one row of caps per row.  Guarantee: for every row and target
    t, size[t] + accepted_inflow[t] <= cap[t] (outflow ignored →
    conservative).  Returns new labels.
    """
    moving = proposal != labels
    vw = torch.where(moving, vwgt, 0.0)
    # sort by (target, -priority): group per target, best first
    order = lexsort((-priority, proposal))
    t_s = proposal.gather(-1, order).long()
    vw_s = vw.gather(-1, order)
    cums = torch.cumsum(vw_s, -1)
    newrun = torch.ones_like(t_s, dtype=torch.bool)
    newrun[:, 1:] = t_s[:, 1:] != t_s[:, :-1]
    base = torch.where(newrun, cums - vw_s, -torch.inf)
    base = torch.cummax(base, -1).values
    inflow = cums - base                  # inclusive inflow within target run
    ok_s = (sizes.gather(-1, t_s) + inflow
            <= cap.expand(t_s.shape[0], -1).gather(-1, t_s))
    ok = torch.zeros_like(moving).scatter_(-1, order, ok_s)
    return torch.where(moving & ok, proposal, labels)


# ---------------------------------------------------------------------------
# k-way dense affinity (plain COO path; the CUDA kernel computes it on ELL)
# ---------------------------------------------------------------------------

def kway_affinity_coo(g: CooGraph, labels: torch.Tensor,
                      k: int) -> torch.Tensor:
    """aff[b, v, c] = weight of edges from v into block c.  (B, n_pad, k)."""
    b = labels.shape[0]
    tgt = labels[:, g.dst_long].long()
    idx = g.src_long * k + tgt
    aff = torch.zeros(b, g.n_pad * k, dtype=torch.float32, device=g.device)
    aff.scatter_add_(1, idx, g.w.expand(b, -1))
    return aff.view(b, g.n_pad, k)


def kway_lp_round(g: CooGraph, labels: torch.Tensor, sizes: torch.Tensor,
                  cap: torch.Tensor, noise: torch.Tensor, k: int,
                  parity: int, active: Optional[torch.Tensor],
                  allow_zero_gain: torch.Tensor, force_balance: torch.Tensor,
                  affinity_fn=None) -> tuple:
    """One batch-synchronous k-way LP/gain round; returns (labels, sizes).

    ``labels`` (B, n_pad) int32, ``sizes`` (B, k), ``noise`` (B, n_pad, k)
    draws in [0, _NOISE), ``allow_zero_gain``/``force_balance`` (B,) bools.
    """
    n = g.n_pad
    aff = (affinity_fn or kway_affinity_coo)(g, labels, k)
    lab = labels.long()
    own = aff.gather(2, lab[..., None])[..., 0]
    gain = aff - own[..., None] + noise
    # own block is not a move target
    gain.scatter_(2, lab[..., None], _NEG)
    # full targets are not candidates
    vw = g.vwgt
    room = sizes[:, None, :] + vw[None, :, None] <= cap
    gain = torch.where(room, gain, _NEG)
    best_gain = gain.amax(2)
    best_tgt = gain.argmax(2).to(labels.dtype)    # first maximum, as jnp
    eps = torch.tensor(_GAIN_EPS, dtype=torch.float32, device=g.device)
    thresh = torch.where(allow_zero_gain, -eps, eps)
    want = best_gain > thresh[:, None]
    # overweight blocks push nodes out regardless of gain (when forced)
    over = sizes.gather(1, lab) > cap[lab]
    want = want | (force_balance[:, None] & over
                   & (best_gain > _NEG / 2) & (vw > 0))
    # parity tie-break (avoid A<->B swap oscillation)
    node_par = (torch.arange(n, device=g.device) + parity) % 2 == 0
    want = want & node_par
    if active is not None:
        want = want & active
    proposal = torch.where(want, best_tgt, labels)
    new_labels = capped_accept(labels, proposal, vw, sizes, cap,
                               torch.where(want, best_gain, _NEG))
    new_sizes = torch.zeros_like(sizes).scatter_add_(
        1, new_labels.long(), vw.expand(labels.shape[0], -1))
    return new_labels, new_sizes


# ---------------------------------------------------------------------------
# clustering LP (labels in [0, n_pad)) — lexsort+segment formulation
# ---------------------------------------------------------------------------

def _segment_affinity(g: CooGraph, labels: torch.Tensor, sizes: torch.Tensor,
                      cap: torch.Tensor, noise: torch.Tensor):
    """Per node: best cluster among neighbours under the size constraint.

    ``noise`` is (e_pad,) draws in [0, _NOISE).  Returns (best_label,
    best_aff, own_aff) tensors of length n_pad.
    """
    n, e, dev = g.n_pad, g.e_pad, g.device
    tgt = labels[g.dst_long]
    # sort live edges first and split runs on the live flag: real edges'
    # positions and run boundaries then depend on real edges alone — by the
    # masking contract (kernels/ops.py) padding (w == 0) edges may point
    # anywhere, and letting their placement shift the sort would leak into
    # the position-keyed tie-break noise below.  Padding edges land in
    # dead-only runs, which aff_eff masks to _NEG.
    dead = (g.w <= 0).to(torch.int32)
    order = lexsort((tgt, g.src, dead))         # runs of equal (src, tgt)
    src_e = g.src_long[order]
    lab_e = tgt[order]
    ws = g.w[order]
    live = ws > 0
    newrun = torch.ones(e, dtype=torch.bool, device=dev)
    newrun[1:] = ((src_e[1:] != src_e[:-1]) | (lab_e[1:] != lab_e[:-1])
                  | (live[1:] != live[:-1]))
    seg = torch.cumsum(newrun, 0) - 1           # (e,) run index
    segsum = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, seg, ws)
    aff_run = segsum[seg]                       # per edge: run's sum
    # random tie-break, consistent within a run
    noise = torch.zeros(e, dtype=torch.float32, device=dev).scatter_reduce_(
        0, seg, noise, "amax")[seg]
    aff_run = aff_run + noise
    # size constraint: target must have room (own cluster always allowed)
    lab_l = lab_e.long()
    own = lab_e == labels[src_e]
    room = (sizes[lab_l] + g.vwgt[src_e] <= cap[lab_l]) | own
    aff_eff = torch.where(room & live, aff_run, _NEG)
    best = torch.full((n,), _NEG, dtype=torch.float32,
                      device=dev).scatter_reduce_(0, src_e, aff_eff, "amax")
    is_best = aff_eff >= best[src_e] - 1e-9
    cand = torch.where(is_best, lab_e, n + 1)
    best_lab = torch.full((n,), n + 1, dtype=torch.int32,
                          device=dev).scatter_reduce_(0, src_e, cand, "amin")
    own_best = torch.zeros(n, dtype=torch.float32, device=dev).scatter_reduce_(
        0, src_e, torch.where(own & live, aff_run, 0.0), "amax")
    return best_lab, best, own_best


def cluster_lp(g: CooGraph, labels0: torch.Tensor, cap: torch.Tensor,
               noise: Noise, iters: int):
    """The clustering LP loop over ``iters`` rounds; returns the labels.

    ``noise`` is an (iters, e_pad) tensor of draws or one generator.
    """
    n = g.n_pad
    vw = g.vwgt
    node_ids = torch.arange(n, device=g.device)
    labels = labels0
    for parity in range(iters):
        sizes = torch.zeros(n, dtype=torch.float32, device=g.device)
        sizes.index_add_(0, labels.long(), vw)
        nz = (noise[parity] if isinstance(noise, torch.Tensor)
              else uniform_noise(noise, (g.e_pad,), g.device))
        best_lab, best_aff, own_aff = _segment_affinity(g, labels, sizes,
                                                        cap, nz)
        improve = (best_aff > own_aff + _GAIN_EPS) & (best_lab < n)
        want = improve & ((node_ids + parity) % 2 == 0)
        proposal = torch.where(want, best_lab, labels).to(labels.dtype)
        pri = torch.where(want, best_aff - own_aff, _NEG)
        labels = capped_accept(labels[None], proposal[None], vw,
                               sizes[None], cap, pri[None])[0]
    return labels


def size_constrained_lp(g: Graph, max_cluster_weight: float,
                        iters: int = 10, seed: int = 0,
                        coo: Optional[CooGraph] = None,
                        device=None) -> np.ndarray:
    """The ``label_propagation`` program: returns a clustering (host ints)."""
    dev = coo.device if coo is not None else resolve_device(device)
    coo = coo if coo is not None else to_coo(g, device=dev)
    n_pad = coo.n_pad
    labels0 = torch.arange(n_pad, dtype=torch.int32, device=dev)
    cap = torch.full((n_pad,), max_cluster_weight, dtype=torch.float32,
                     device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    labels = cluster_lp(coo, labels0, cap, gen, iters)
    return labels.cpu().numpy()[:g.n]
