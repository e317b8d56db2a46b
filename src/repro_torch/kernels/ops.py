"""Public wrappers around the hand-written kernels.

Dispatch follows the tensor's device: a CPU tensor takes the plain PyTorch
version (kernels/ref.py), a CUDA tensor launches the CUDA kernel or raises.
Nothing falls back.

Masking contract: every input dimension may arrive padded to its pow2
shape bucket, and correctness relies ONLY on weight masks — ``wgt == 0``
for ELL slots, ``pin_mask == 0`` for pin slots, ``netw == 0`` for padding
nets.  Index sentinels (slot id n_pad-1 etc.) are never trusted as masks:
a padded slot may alias a real row when a dim lands exactly on its
bucket, and the ids in padding slots may be any valid vertex.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lp_affinity as _lpk
from repro_torch.kernels import pin_affinity as _pink
from repro_torch.kernels import ref as _ref

#: Machine-readable form of the masking contract above, keyed by public op:
#: ``mask`` is the argument whose zeros mark padding slots, ``garbage`` the
#: index arguments whose padded slots are unconstrained (any valid id).
PADDING_CONTRACT = {
    "lp_affinity": {"mask": "wgt", "garbage": ("nbr",)},
    "pin_count": {"mask": "pin_mask", "garbage": ("pins",)},
    "pin_affinity": {"mask": "pin_mask", "garbage": ("pins", "vnets")},
}


def lp_affinity(nbr: torch.Tensor, wgt: torch.Tensor, labels: torch.Tensor,
                k: int) -> torch.Tensor:
    """ELL graph + batched labels (B, n_pad) → (B, n_pad, k) affinities."""
    if nbr.device.type == "cpu":
        return _ref.affinity_ref(nbr, wgt, labels, k)
    return _lpk.affinity_cuda(nbr, wgt, labels.contiguous(), k)


def pin_count(pins: torch.Tensor, pin_mask: torch.Tensor,
              netw: torch.Tensor, labels: torch.Tensor, k: int):
    """Net→pin ELL + batched labels (B, n_pad) → (cnt, score), each
    (B, e_pad, k): per-net pin counts and net-weighted counts."""
    if pins.device.type == "cpu":
        return _ref.pin_count_ref(pins, pin_mask, netw, labels, k)
    return _pink.pin_count_cuda(pins, pin_mask, netw, labels.contiguous(), k)


def pin_affinity(vnets: torch.Tensor, pins: torch.Tensor,
                 pin_mask: torch.Tensor, netw: torch.Tensor,
                 labels: torch.Tensor, k: int) -> torch.Tensor:
    """Dual-ELL hypergraph + batched labels → (B, n_pad, k) affinities:

        aff[b, v, c] = Σ_{e ∋ v} w(e) · |{pins of e with label c}|

    Per-net scores come from ``pin_count`` (the kernel on a CUDA tensor);
    the vertex-side sum over ``vnets`` rows is plain torch on either device
    (padding slots point at a zero-weight net)."""
    return _ref.pin_affinity_ref(vnets, pins, pin_mask, netw, labels, k,
                                 pin_count=pin_count)
