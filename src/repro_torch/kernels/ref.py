"""Plain PyTorch versions of the hand-written kernels.

The CPU tests run these, and ``chip_smoke.py`` holds each kernel against
its plain version on the card.
"""
from __future__ import annotations

import torch


def affinity_ref(nbr: torch.Tensor, wgt: torch.Tensor, labels: torch.Tensor,
                 k: int) -> torch.Tensor:
    """aff[b, v, c] = Σ_j wgt[v, j] · [labels[b, nbr[v, j]] == c].

    ``nbr`` int32 (n_pad, dmax), ``wgt`` f32 (n_pad, dmax), ``labels``
    int32 (B, n_pad) → f32 (B, n_pad, k).  The slots are added in order
    j = 0, 1, ..., as the CUDA kernel adds them, and labels outside [0, k)
    hit no block.  Padding slots (wgt == 0) add exact zeros, so their
    (valid) neighbour ids do not matter.
    """
    nbr_lab = labels[:, nbr.long()]                      # (B, n_pad, dmax)
    blocks = torch.arange(k, dtype=labels.dtype, device=labels.device)
    aff = torch.zeros(labels.shape[0], nbr.shape[0], k, dtype=torch.float32,
                      device=labels.device)
    for j in range(nbr.shape[1]):
        hit = nbr_lab[:, :, j, None] == blocks
        aff += wgt[None, :, j, None] * hit
    return aff


def pin_count_ref(pins: torch.Tensor, pin_mask: torch.Tensor,
                  netw: torch.Tensor, labels: torch.Tensor, k: int):
    """(cnt, score) with cnt[b, e, c] = Σ_j pin_mask[e, j] ·
    [labels[b, pins[e, j]] == c] and score = netw[e] · cnt.

    ``pins`` int32 (e_pad, pmax), ``pin_mask`` f32 (e_pad, pmax), ``netw``
    f32 (e_pad,), ``labels`` int32 (B, n_pad) → two f32 (B, e_pad, k).  The
    slots are added in order j = 0, 1, ..., as the CUDA kernel adds them,
    and labels outside [0, k) hit no block.  Padding slots (pin_mask == 0)
    add exact zeros, so their (valid) pin ids do not matter.
    """
    pin_lab = labels[:, pins.long()]                     # (B, e_pad, pmax)
    blocks = torch.arange(k, dtype=labels.dtype, device=labels.device)
    cnt = torch.zeros(labels.shape[0], pins.shape[0], k, dtype=torch.float32,
                      device=labels.device)
    for j in range(pins.shape[1]):
        hit = pin_lab[:, :, j, None] == blocks
        cnt += pin_mask[None, :, j, None] * hit
    return cnt, cnt * netw[:, None]


def pin_affinity_ref(vnets: torch.Tensor, pins: torch.Tensor,
                     pin_mask: torch.Tensor, netw: torch.Tensor,
                     labels: torch.Tensor, k: int,
                     pin_count=pin_count_ref) -> torch.Tensor:
    """aff[b, v, c] = Σ_{e ∈ vnets[v]} score[b, e, c]  — (B, n_pad, k).

    Padding slots of ``vnets`` point at a padding net (netw == 0).  The
    per-net scores come from ``pin_count``; ``ops.pin_affinity`` passes
    its device-dispatching one, so this is the only vertex-side sum."""
    _, score = pin_count(pins, pin_mask, netw, labels, k)
    return score[:, vnets.long()].sum(2)
