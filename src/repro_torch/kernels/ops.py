"""Public wrappers around the hand-written kernels.

Dispatch follows the tensor's device: a CPU tensor takes the plain PyTorch
version (kernels/ref.py), a CUDA tensor launches the CUDA kernel or raises.
Nothing falls back.

Masking contract: every input dimension may arrive padded to its pow2
shape bucket, and correctness relies ONLY on weight masks — ``wgt == 0``
for ELL slots.  Index sentinels (slot id n_pad-1) are never trusted as
masks: a padded slot may alias a real row when a dim lands exactly on its
bucket, and the ids in padding slots may be any valid vertex.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lp_affinity as _lpk
from repro_torch.kernels import ref as _ref


def lp_affinity(nbr: torch.Tensor, wgt: torch.Tensor, labels: torch.Tensor,
                k: int) -> torch.Tensor:
    """ELL graph + batched labels (B, n_pad) → (B, n_pad, k) affinities."""
    if nbr.device.type == "cpu":
        return _ref.affinity_ref(nbr, wgt, labels, k)
    return _lpk.affinity_cuda(nbr, wgt, labels.contiguous(), k)
