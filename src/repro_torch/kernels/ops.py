"""Public wrappers around the hand-written kernels.

Dispatch follows the tensor's device: a CPU tensor takes the plain PyTorch
version (kernels/ref.py), a CUDA tensor launches the CUDA kernel or raises.
Nothing falls back.

Masking contract: every input dimension may arrive padded to its pow2
shape bucket, and correctness relies ONLY on weight masks — ``wgt == 0``
for ELL slots, ``pin_mask == 0`` for pin slots, ``netw == 0`` for padding
nets.  Index sentinels (slot id n_pad-1 etc.) are never trusted as masks:
a padded slot may alias a real row when a dim lands exactly on its
bucket, and the ids in padding slots may be any valid vertex.  The pin
list of ``pin_count_csr`` is addressed by its offsets instead: pins past
``eptr[-1]`` lie in no net, so their ids and weights may be anything.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import attention as _attk
from repro_torch.kernels import lp_affinity as _lpk
from repro_torch.kernels import pin_affinity as _pink
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssdk
from repro_torch.obs import metrics

#: The count of ``sep_affinity`` calls that launched the CUDA kernel (each
#: is also one of ``lp_affinity``'s launches, at k = 3).
SEP_LAUNCHES = "kernels/sep_affinity/launches"

#: Machine-readable form of the masking contract above, keyed by public op:
#: ``mask`` is the argument whose zeros mark padding slots, ``garbage`` the
#: index arguments whose padded slots are unconstrained (any valid id).
#: ``tail`` names the arguments that ``ssd_scan`` pads along L with zero
#: steps (log-decay 0, so decay 1, and b = x = 0): such steps leave the
#: state, and so every real output, unchanged.
PADDING_CONTRACT = {
    "lp_affinity": {"mask": "wgt", "garbage": ("nbr",)},
    "sep_affinity": {"mask": "wgt", "garbage": ("nbr",)},
    "pin_count": {"mask": "pin_mask", "garbage": ("pins",)},
    "pin_count_csr": {"mask": "mask", "garbage": ("pv",)},
    "pin_affinity": {"mask": "pin_mask", "garbage": ("pins", "vnets")},
    "ssd_scan": {"tail": ("x", "logdecay", "b", "c")},
}


def lp_affinity(nbr: torch.Tensor, wgt: torch.Tensor, labels: torch.Tensor,
                k: int) -> torch.Tensor:
    """ELL graph + batched labels (B, n_pad) → (B, n_pad, k) affinities.

    On a CUDA tensor dmax is padded to a multiple of 4 with zero-weight
    slots (inert, see ``PADDING_CONTRACT``) for the kernel's 16-byte
    loads."""
    if nbr.device.type == "cpu":
        return _ref.affinity_ref(nbr, wgt, labels, k)
    nbr, wgt = (pad_to(t, 1, 4).contiguous() for t in (nbr, wgt))
    return _lpk.affinity_cuda(nbr, wgt, labels.contiguous(), k)


def sep_weights(nbr: torch.Tensor, wgt: torch.Tensor,
                vwgt: torch.Tensor) -> torch.Tensor:
    """(n_pad, dmax) slot weights of the separator gain: each live slot's
    neighbour vertex weight, 0 on padding.  ``wgt > 0`` gates the gather,
    never the slot id: a padding slot points at n_pad - 1, a real vertex
    when n == n_pad.  It depends on the graph alone, so callers build it
    once per view."""
    return torch.where(wgt > 0, vwgt[nbr.long()], 0.0)


def sep_affinity(nbr: torch.Tensor, wgt: torch.Tensor, vwgt: torch.Tensor,
                 labels: torch.Tensor, vw_nbr=None) -> torch.Tensor:
    """ELL graph + batched 3-labels (B, n_pad) → (B, n_pad, 3) neighbour
    *vertex-weight* histogram, the separator-gain contraction:

        aff[b, v, c] = Σ_j vwgt[nbr[v, j]] · [wgt[v, j] > 0]
                           · [labels[b, nbr[v, j]] == c]

    ``lp_affinity`` at k = 3 over ``sep_weights(nbr, wgt, vwgt)``, which a
    caller that holds it passes as ``vw_nbr``."""
    if vw_nbr is None:
        vw_nbr = sep_weights(nbr, wgt, vwgt)
    aff = lp_affinity(nbr, vw_nbr, labels, 3)
    if nbr.device.type == "cuda":
        metrics.inc(SEP_LAUNCHES)
    return aff


def pin_count(pins: torch.Tensor, pin_mask: torch.Tensor,
              netw: torch.Tensor, labels: torch.Tensor, k: int):
    """Net→pin ELL + batched labels (B, n_pad) → (cnt, score), each
    (B, e_pad, k): per-net pin counts and net-weighted counts."""
    if pins.device.type == "cpu":
        return _ref.pin_count_ref(pins, pin_mask, netw, labels, k)
    return _pink.pin_count_cuda(pins, pin_mask, netw, labels.contiguous(), k)


def pin_count_csr(eptr: torch.Tensor, pv: torch.Tensor, mask: torch.Tensor,
                  labels: torch.Tensor, k: int) -> torch.Tensor:
    """Pin list (net e's pins ``pv[eptr[e]:eptr[e+1]]``, weights ``mask``)
    + batched labels (B, n_pad) → (B, e_pad, k) per-net pin counts."""
    if pv.device.type == "cpu":
        return _ref.pin_count_csr_ref(eptr, pv, mask, labels, k)
    return _pink.pin_count_csr_cuda(eptr, pv, mask, labels.contiguous(), k)


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
             c: torch.Tensor, chunk: int = 128, heads: int = 1) -> torch.Tensor:
    """Mamba2 SSD scan: x (BH, L, P), logdecay (BH, L), b and c
    (BH / heads, L, N) → y (BH, L, P).

    Rows of x come in groups of ``heads`` consecutive rows that share one
    row of b and c (a Mamba2 layer's heads share its single B/C group);
    ``heads=1`` is the per-row form.  L is padded with zero steps to a
    multiple of ``chunk`` (inert, see ``PADDING_CONTRACT``).  A CPU tensor
    takes the exact recurrence (``ref.ssd_scan_grouped_ref``: b and c
    expanded to every head); a CUDA tensor launches the kernels on the
    un-expanded b and c, with N zero-padded to a multiple of 16 and P of 8
    (zero state rows and columns change no real output).

    The kernels have no backward, nor has the JAX package's Pallas
    kernel: on a CUDA tensor under grad mode with an input that requires
    a gradient this raises rather than return a result cut from the
    graph.  Training runs ``mamba2_mixer(engine="chunked")``.
    """
    l, p = x.shape[1], x.shape[2]
    if heads < 1 or x.shape[0] != b.shape[0] * heads:
        raise ValueError(f"x has {x.shape[0]} rows, b {b.shape[0]}: not "
                         f"{heads} heads per row of b")
    if (x.device.type != "cpu" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, logdecay, b, c))):
        raise RuntimeError(
            "ops.ssd_scan: the SSD kernel has no backward (neither has the "
            "JAX package's ssd_scan_pallas); train the hybrid family with "
            "mamba2_mixer(engine='chunked')")
    x, logdecay, b, c = (pad_to(t, 1, chunk) for t in (x, logdecay, b, c))
    if x.device.type == "cpu":
        y = _ref.ssd_scan_grouped_ref(x, logdecay, b, c, heads)
    else:
        x = pad_to(x, 2, _ssdk.P_MULT).contiguous()
        b, c = (pad_to(t, 2, _ssdk.N_MULT).contiguous() for t in (b, c))
        y = _ssdk.ssd_scan_cuda(x, logdecay.contiguous(), b, c, chunk,
                                heads)
    return y[:, :l, :p]


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, q_offset: int = 0, window=None,
                  is_causal: bool = True, cap=None) -> torch.Tensor:
    """Attention forward: q (B, Sq, H, hd), k and v (B, Skv, KV, hd), query
    head h reading KV head h // (H / KV) → (B, Sq, H, hd).

    Query row i sits at position i + ``q_offset`` (an int), key j at j;
    ``is_causal`` keeps keys j <= i + q_offset, ``window`` (None = global)
    keys j > i + q_offset − window; scores are ``scale``·q·k, softcapped
    by ``cap``, and a masked score is -1e30 (a row with no key left
    averages every value).  A CPU tensor takes the plain version
    (``ref.attention_ref``); a CUDA tensor launches the fused kernel (f32,
    hd in 64, 80, 128; strides the kernel cannot read are copied first)
    or raises.

    The kernel has no backward: on a CUDA tensor under grad mode with an
    input that requires a gradient this raises rather than return a result
    cut from the graph.  ``models/attention.attention`` sends such calls to
    its composed path.
    """
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, scale=scale, q_offset=q_offset,
                                  window=window, is_causal=is_causal,
                                  cap=cap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "ops.attention_fwd: the fused attention kernel has no backward; "
            "models/attention.attention takes the composed path for inputs "
            "that need a gradient")
    q, k, v = (t if _attk.readable(t) else t.contiguous() for t in (q, k, v))
    return _attk.attention_cuda(q, k, v, scale=scale, q_offset=q_offset,
                                window=window, is_causal=is_causal, cap=cap)
