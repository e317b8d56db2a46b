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
from repro_torch.kernels import ssd_scan as _ssdk

#: Machine-readable form of the masking contract above, keyed by public op:
#: ``mask`` is the argument whose zeros mark padding slots, ``garbage`` the
#: index arguments whose padded slots are unconstrained (any valid id).
#: ``tail`` names the arguments that ``ssd_scan`` pads along L with zero
#: steps (log-decay 0, so decay 1, and b = x = 0): such steps leave the
#: state, and so every real output, unchanged.
PADDING_CONTRACT = {
    "lp_affinity": {"mask": "wgt", "garbage": ("nbr",)},
    "pin_count": {"mask": "pin_mask", "garbage": ("pins",)},
    "pin_affinity": {"mask": "pin_mask", "garbage": ("pins", "vnets")},
    "ssd_scan": {"tail": ("x", "logdecay", "b", "c")},
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


def pad_to(t: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    """``t`` with zeros appended along ``dim`` up to a multiple of
    ``mult`` (``t`` itself when it is one already)."""
    pad = (-t.shape[dim]) % mult
    if not pad:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim)


def ssd_scan(x: torch.Tensor, logdecay: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Mamba2 SSD scan: (BH, L, P) × (BH, L) × (BH, L, N)² → (BH, L, P).

    L is padded with zero steps to a multiple of ``chunk`` (inert, see
    ``PADDING_CONTRACT``).  A CPU tensor takes the exact recurrence
    ``ref.ssd_scan_ref``; a CUDA tensor launches the kernel, with N and P
    zero-padded to multiples of 4 (zero state rows and columns change no
    real output).
    """
    l, p = x.shape[1], x.shape[2]
    x, logdecay, b, c = (pad_to(t, 1, chunk) for t in (x, logdecay, b, c))
    if x.device.type == "cpu":
        y = _ref.ssd_scan_ref(x, logdecay, b, c)
    else:
        x = pad_to(x, 2, 4)
        b, c = pad_to(b, 2, 4), pad_to(c, 2, 4)
        y = _ssdk.ssd_scan_cuda(x.contiguous(), logdecay.contiguous(),
                                b.contiguous(), c.contiguous(), chunk)
    return y[:, :l, :p]
