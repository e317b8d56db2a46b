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


def pin_count_csr_ref(eptr: torch.Tensor, pv: torch.Tensor,
                      mask: torch.Tensor, labels: torch.Tensor,
                      k: int) -> torch.Tensor:
    """cnt[b, e, c] = Σ_{p ∈ [eptr[e], eptr[e+1])} mask[p] ·
    [labels[b, pv[p]] == c].

    ``eptr`` int32 (e_pad + 1,) offsets into ``pv`` int32 and ``mask`` f32
    (p_pad,), ``labels`` int32 (B, n_pad) → f32 (B, e_pad, k).  Each net's
    pins are added in order, rank 0, 1, ..., as ``pin_count_ref`` adds its
    slots, and labels outside [0, k) hit no block.  Pins past ``eptr[-1]``
    lie in no net and are never read.
    """
    dev = labels.device
    e_pad = eptr.shape[0] - 1
    cnt = torch.zeros(labels.shape[0], e_pad, k, dtype=torch.float32,
                      device=dev)
    start = eptr[:-1].long()
    size = eptr[1:].long() - start
    order = torch.argsort(size, descending=True, stable=True)
    # nets with more than j pins are the first live[j] of ``order``
    ranks = torch.arange(int(size.max()) if e_pad else 0, device=dev)
    live = (e_pad - torch.searchsorted(size[order].flip(0), ranks,
                                       right=True)).tolist()
    blocks = torch.arange(k, dtype=labels.dtype, device=dev)
    for j, n_live in enumerate(live):
        nets = order[:n_live]
        pins = start[nets] + j
        hit = labels[:, pv[pins].long(), None] == blocks     # (B, n_live, k)
        cnt.index_add_(1, nets, mask[pins][None, :, None] * hit)
    return cnt


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


def ssd_scan_ref(x: torch.Tensor, logdecay: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """Exact sequential SSD recurrence (the SSD kernel's plain version).

    h_t = exp(logdecay_t) · h_{t-1} + b_t ⊗ x_t ;  y_t = h_tᵀ c_t
    x: (BH, L, P), logdecay: (BH, L), b/c: (BH, L, N) → y: (BH, L, P), f32.
    """
    bh, l, p = x.shape
    n = b.shape[-1]
    h = torch.zeros(bh, n, p, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        h = (torch.exp(logdecay[:, t])[:, None, None] * h
             + b[:, t, :, None] * x[:, t, None, :])
        ys.append(torch.einsum("znp,zn->zp", h, c[:, t]))
    if not ys:
        return torch.zeros(bh, 0, p, dtype=torch.float32, device=x.device)
    return torch.stack(ys, 1)


def ssd_scan_grouped_ref(x: torch.Tensor, logdecay: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """``ssd_scan_ref`` with b and c shared by groups of ``heads``
    consecutive rows of x: b/c (BH / heads, L, N), expanded to every row."""
    if heads != 1:
        g, l, n = b.shape
        b, c = (m[:, None].expand(g, heads, l, n).reshape(g * heads, l, n)
                for m in (b, c))
    return ssd_scan_ref(x, logdecay, b, c)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, q_offset: int = 0, window=None,
                  is_causal: bool = True, cap=None) -> torch.Tensor:
    """Attention over the whole (Sq, Skv) score matrix (the fused
    attention kernel's plain version).

    q (B, Sq, H, hd), k and v (B, Skv, KV, hd); query head h reads KV head
    h // (H / KV).  Query row i sits at position i + ``q_offset``, key j
    at j: ``is_causal`` keeps keys j <= i + q_offset and ``window`` (None
    = global) keys j > i + q_offset − window.  Scores are scale·q·k,
    then cap·tanh(·/cap) when ``cap`` is given; a masked score is -1e30,
    so a row with no key left averages every value.  → f32 (B, Sq, H, hd).
    """
    sq, skv = q.shape[1], k.shape[1]
    rep = q.shape[2] // k.shape[2]
    k, v = (t.float().repeat_interleave(rep, 2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    key = torch.arange(skv, device=q.device)[None, :]
    keep = (key <= qpos) if is_causal else torch.ones_like(key <= qpos)
    if window is not None:
        keep = keep & (key > qpos - window)
    p = torch.softmax(s.masked_fill(~keep, -1e30), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
