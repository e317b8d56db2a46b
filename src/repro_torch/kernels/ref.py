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
