"""Size-constrained LP uncoarsening refinement for hypergraphs — device side.

Batch-synchronous k-way LP with exact move gains for both objectives:

  * connectivity (λ−1):  moving v from a to b removes w(e) for every net
    where v is a's sole pin, and adds w(e) for every net with no pin in b:
       gain(v, b) = R(v) − W(v) + A(v, b)
    with R(v) = Σ_{e∋v} w(e)·[cnt(e, a) = 1],  W(v) = Σ_{e∋v} w(e),
    A(v, b) = Σ_{e∋v} w(e)·[cnt(e, b) ≥ 1].
  * cut-net:  gain(v, b) = Σ_{e∋v} w(e)·[cnt(e, b) = |e|−1]
                         − Σ_{e∋v} w(e)·[cnt(e, a) = |e|].

Moves are applied with the same capped acceptance (hard balance guarantee)
and undo-to-best semantics as the graph refiner (core/lp.py,
core/refine.py).  Per-net pin counts come either from the CUDA pin-count
kernel (given an ELL-H view, ``kernels/ops.pin_count``) or a COO scatter
(the plain path); both are exact integer counts, so the two paths take the
same decisions.

The scan takes a leading batch dim of candidate rows.  Tie-break noise is
an argument: a (B, rounds, n_pad, k_pad) tensor (the tests hand in the JAX
package's draws) or one torch.Generator per row, seeded by
``row_seed(seed, row)``, so a row never depends on the rows beside it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import lp as lp_mod
from repro_torch.core.csr import _pow2_pad, resolve_device
from repro_torch.core.hypergraph import metrics as M
from repro_torch.core.hypergraph.container import (EllHypergraph, Hypergraph,
                                                   PinCoo, to_ell_h,
                                                   to_pincoo)
from repro_torch.core.refine import (_generators, _round_noise,
                                     default_use_kernel, row_seed)

_NEG = lp_mod._NEG
_GAIN_EPS = lp_mod._GAIN_EPS


def _gains(hc: PinCoo, labels: torch.Tensor, cnt: torch.Tensor,
           w_pin: torch.Tensor, wtot: torch.Tensor, k: int,
           objective: str) -> torch.Tensor:
    """(B, n_pad, k) move gains from (B, e_pad, k) pin counts, composed in
    the reference's order so that ties break identically."""
    b, n = labels.shape[0], hc.n_pad
    dev = labels.device
    cnt_e = cnt.index_select(1, hc.pe_long)                  # (B, p_pad, k)
    lab_pin = labels[:, hc.pv_long].long()
    cnt_own = cnt_e.gather(2, lab_pin[..., None])[..., 0]    # (B, p_pad)
    if objective == "km1":
        pres = (cnt_e > 0).to(torch.float32)
        aff = torch.zeros(b, n, k, dtype=torch.float32, device=dev)
        aff.index_add_(1, hc.pv_long, w_pin[None, :, None] * pres)
        rem = torch.zeros(b, n, dtype=torch.float32, device=dev)
        rem.index_add_(1, hc.pv_long, w_pin * (cnt_own == 1))
        return rem[:, :, None] - wtot[None, :, None] + aff
    esz = hc.esize[hc.pe_long]
    makes = (cnt_e == (esz - 1.0)[None, :, None]).to(torch.float32)
    joins = torch.zeros(b, n, k, dtype=torch.float32, device=dev)
    joins.index_add_(1, hc.pv_long, w_pin[None, :, None] * makes)
    breaks = torch.zeros(b, n, dtype=torch.float32, device=dev)
    breaks.index_add_(1, hc.pv_long, w_pin * (cnt_own == esz))
    return joins - breaks[:, :, None]


def _hyper_refine_scan_batch(hc: PinCoo, labels0: torch.Tensor,
                             cap: torch.Tensor, noise: lp_mod.Noise,
                             force: torch.Tensor, k: int, rounds: int,
                             objective: str,
                             ell: Optional[EllHypergraph] = None,
                             nrounds: Optional[torch.Tensor] = None):
    """THE hypergraph refinement program: everything routes through here.

    ``labels0`` (B, n_pad) int32 candidates; ``cap`` (k,) with zero
    capacity on bucket-padding blocks; ``noise`` the per-round draws, a
    (B, rounds, n_pad, k) tensor or B generators; ``force`` (B,) bools;
    ``nrounds`` (B,) optionally masks a row's trailing rounds to no-ops
    (default: every row runs ``rounds``).  With an ``ell`` view the pin
    counts come from ``kernels/ops.pin_count`` (the CUDA kernel on a card),
    without one from the COO scatter.  Returns (labels (B, n_pad),
    best objective (B,)).  Rounds past every row's ``nrounds`` are not run.
    """
    n = hc.n_pad
    b = labels0.shape[0]
    dev = hc.device
    vw = hc.vwgt
    w_pin = hc.mask * hc.netw[hc.pe_long]                    # (p_pad,)
    wtot = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
        0, hc.pv_long, w_pin)
    if nrounds is None:
        nrounds = torch.full((b,), rounds, dtype=torch.int64, device=dev)

    if ell is not None:
        from repro_torch.kernels import ops as kops

        def cnt_fn(labels):
            return kops.pin_count(ell.pins, ell.pin_mask, ell.netw, labels,
                                  k)[0]
    else:
        def cnt_fn(labels):
            return M.pin_counts_device(hc, labels, k)

    obj_fn = M.km1_device if objective == "km1" else M.cut_net_device

    def track(labels, sizes, cnt, best_obj, best_labels):
        """Undo-to-best: keep the best feasible state seen."""
        obj = obj_fn(cnt, hc.netw)
        feas = (sizes - cap).amax(1) <= 1e-6
        better = feas & (obj < best_obj)
        return (torch.where(better, obj, best_obj),
                torch.where(better[:, None], labels, best_labels))

    sizes = torch.zeros(b, k, dtype=torch.float32, device=dev).scatter_add_(
        1, labels0.long(), vw.expand(b, -1))
    labels, best_labels = labels0, labels0
    best_obj = torch.full((b,), torch.inf, dtype=torch.float32, device=dev)
    node_ids = torch.arange(n, device=dev)
    for parity in range(min(rounds, int(nrounds.max()))):
        cnt = cnt_fn(labels)
        best_obj, best_labels = track(labels, sizes, cnt, best_obj,
                                      best_labels)
        # propose + accept moves
        gain = _gains(hc, labels, cnt, w_pin, wtot, k, objective)
        gain = gain + _round_noise(noise, parity, n, k, dev)
        lab = labels.long()
        gain.scatter_(2, lab[..., None], _NEG)
        room = sizes[:, None, :] + vw[None, :, None] <= cap
        gain = torch.where(room, gain, _NEG)
        best_gain = gain.amax(2)
        best_tgt = gain.argmax(2).to(labels.dtype)    # first maximum, as jnp
        want = best_gain > _GAIN_EPS
        # overweight blocks push nodes out regardless of gain (when forced)
        over = sizes.gather(1, lab) > cap[lab]
        want = want | (force[:, None] & over & (best_gain > _NEG / 2)
                       & (vw > 0))
        want = want & ((node_ids + parity) % 2 == 0)
        proposal = torch.where(want, best_tgt, labels)
        prop_labels = lp_mod.capped_accept(labels, proposal, vw, sizes, cap,
                                           torch.where(want, best_gain, _NEG))
        prop_sizes = torch.zeros_like(sizes).scatter_add_(
            1, prop_labels.long(), vw.expand(b, -1))
        live = (parity < nrounds)[:, None]
        labels = torch.where(live, prop_labels, labels)
        sizes = torch.where(live, prop_sizes, sizes)
    # evaluate the final state too
    best_obj, best_labels = track(labels, sizes, cnt_fn(labels), best_obj,
                                  best_labels)
    have = torch.isfinite(best_obj)
    return torch.where(have[:, None], best_labels, labels), best_obj


def _caps_for(hg: Hypergraph, k: int, eps: float) -> np.ndarray:
    lmax = np.ceil(hg.total_vwgt() / k)
    return np.full(k, (1.0 + eps) * lmax)


def k_bucket(k: int) -> int:
    """pow2 block-count bucket with floor 4, as the JAX package's: fake
    blocks get zero capacity, so no vertex ever moves into one."""
    return _pow2_pad(max(k, 4), 1)


def _pad_caps(cap: np.ndarray, k_pad: int) -> np.ndarray:
    out = np.zeros(k_pad, np.float32)
    out[:len(cap)] = cap
    return out


def _views(hg: Hypergraph, hc, ell, use_kernel, device):
    """Resolve (hc, ell) for a host-level entry: cached views fix the
    device, else ``device`` does (None = CUDA).  ``ell`` is None exactly
    when the scan is to take the COO path."""
    dev = hc.device if hc is not None else resolve_device(device)
    use_kernel = default_use_kernel(dev) if use_kernel is None else use_kernel
    hc = hc if hc is not None else to_pincoo(hg, device=dev)
    if not use_kernel:
        return hc, None
    return hc, ell if ell is not None else to_ell_h(hg, device=dev)


def _run_hyper_scan_batch(hg, hc, ell, parts, k, eps, rounds, seeds, force,
                          objective) -> np.ndarray:
    """Shared batched-entry plumbing: host partitions in, host int64 rows
    (cut to ``hg.n``) out."""
    dev = hc.device
    k_pad = k_bucket(k)
    labs = np.zeros((len(parts), hc.n_pad), dtype=np.int32)
    for i, p in enumerate(parts):
        labs[i, :hg.n] = p
    outs, _ = _hyper_refine_scan_batch(
        hc, torch.from_numpy(labs).to(dev),
        torch.from_numpy(_pad_caps(_caps_for(hg, k, eps), k_pad)).to(dev),
        _generators(seeds, dev),
        torch.as_tensor(np.asarray(force, dtype=bool)).to(dev), k_pad,
        rounds, objective, ell=ell)
    return outs.cpu().numpy().astype(np.int64)[:, :hg.n]


def refine_hypergraph(hg: Hypergraph, part: np.ndarray, k: int,
                      eps: float = 0.03, rounds: int = 12, seed: int = 0,
                      objective: str = "km1",
                      force_balance: bool = False,
                      use_kernel: Optional[bool] = None,
                      hc: Optional[PinCoo] = None,
                      ell: Optional[EllHypergraph] = None,
                      device=None) -> np.ndarray:
    """Polish ``part``; never returns a worse feasible objective.

    ``use_kernel=None`` resolves to the device default (the CUDA kernel on
    a card, the COO scatter on the CPU); ``hc``/``ell`` accept cached
    per-level views, which also fix the device.
    """
    if k <= 1 or hg.n == 0:
        return np.asarray(part, dtype=np.int64)
    hc, ell = _views(hg, hc, ell, use_kernel, device)
    out = _run_hyper_scan_batch(hg, hc, ell, [part], k, eps, rounds,
                                [row_seed(seed, 0)], [force_balance],
                                objective)[0]
    score = M.connectivity if objective == "km1" else M.cut_net
    # paranoia: keep the better of (in, out) among feasible options
    if score(hg, out) <= score(hg, part) or force_balance:
        return out
    return np.asarray(part, dtype=np.int64)


def refine_hypergraph_batch(hg: Hypergraph, parts: list, k: int,
                            eps: float = 0.03, rounds: int = 12,
                            seed: int = 0, objective: str = "km1",
                            use_kernel: Optional[bool] = None,
                            hc: Optional[PinCoo] = None,
                            ell: Optional[EllHypergraph] = None,
                            seeds: Optional[Sequence[int]] = None,
                            device=None) -> list:
    """Refine several candidate partitions in one batched device call (the
    initial-partition tournament).  ``seeds`` overrides the per-candidate
    generator seeds (default ``row_seed(seed, i)`` for row i)."""
    if k <= 1 or hg.n == 0 or not parts:
        return [np.asarray(p, dtype=np.int64) for p in parts]
    hc, ell = _views(hg, hc, ell, use_kernel, device)
    force = [not M.is_feasible(hg, p, k, eps) for p in parts]
    if seeds is None:
        seeds = [row_seed(seed, i) for i in range(len(parts))]
    outs = _run_hyper_scan_batch(hg, hc, ell, parts, k, eps, rounds, seeds,
                                 force, objective)
    score = M.connectivity if objective == "km1" else M.cut_net
    result = []
    for i, p in enumerate(parts):
        if score(hg, outs[i]) <= score(hg, p) or force[i]:
            result.append(outs[i])
        else:
            result.append(np.asarray(p, dtype=np.int64))
    return result
