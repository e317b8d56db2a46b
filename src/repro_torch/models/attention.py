"""GQA attention with RoPE and a KV cache (port of
``repro/models/attention.py``): causal or bidirectional self-attention,
sliding windows (gemma2's local layers), the config's logit softcap, and
cross-attention to precomputed K/V (``kv_override``, ``init_cross_kv``:
whisper's decoder).

Every position cursor is per row: ``cache_pos`` may be a (B,) tensor, so a
batch of slots, each at its own position, runs as one batch dimension
(per-row RoPE positions, causal masks and cache writes) where the
reference vmaps one slot at a time.  The cache is written in place.  An
int cursor stays on the host: no position is copied to the card, so a
step makes no host sync.

Context parallelism (``seq_split``: `shardings.SeqSplitCaches`): data
rank i holds cache positions i·S … (i+1)·S − 1 of the whole batch, S
the local length.  A step writes only the positions the rank owns; each
rank scores its own keys under the causal mask and window taken by
*global* position (a window crosses rank boundaries), softcaps them, and
the online-softmax triple is merged over ``data``: the running max by a
pmax, the exp-sum and the weighted values by one psum.  A split of one
(a data extent of 1) merges nothing and takes the unsplit path.

The scores and their softmax run in one of two ways, chosen from what the
inputs show (``kernel_takes``): the fused kernel (``ops.attention_fwd``:
no logits tensor in device memory, tiles the mask removes never computed)
for f32 CUDA inputs that need no gradient, or else the composed path
(``_sdpa``, or ``_sdpa_online`` above ``ONLINE_THRESHOLD``²), which is
the only path with a backward and the one the kernel is held to.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import attention as ATK
from repro_torch.kernels import ops
from repro_torch.models import shardings as SH
from repro_torch.models.layers import (apply_rope, causal_mask, normal,
                                       rope_freqs, softcap, whole)
from repro_torch.obs import metrics


def init_attn(gen: torch.Generator, cfg, dtype, keep=whole) -> dict:
    """The reference's draws, in its order; ``keep`` as in
    ``moe.init_moe``, given ``attn.wq`` and so on."""
    d = cfg.d_model
    hd = cfg.hd
    s = 0.02
    return {
        "wq": keep("attn.wq", normal(gen, (d, cfg.n_heads * hd), s, dtype)),
        "wk": keep("attn.wk", normal(gen, (d, cfg.n_kv_heads * hd), s, dtype)),
        "wv": keep("attn.wv", normal(gen, (d, cfg.n_kv_heads * hd), s, dtype)),
        "wo": keep("attn.wo", normal(gen, (cfg.n_heads * hd, d), s, dtype)),
    }


def _sdpa(q, k, v, mask, cap, scale):
    """q: (B,Sq,H,hd) k/v: (B,Skv,KV,hd) with GQA broadcast; mask
    (Sq,Skv) or per row (B,Sq,Skv), True = attend (it carries the
    causality and the window: see ``attention``)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, sq, kvh, rep, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float() * scale
    logits = softcap(logits, cap)
    mask = mask.reshape((-1,) + mask.shape[-2:])[:, None, None]
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, -1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v)
    return out.reshape(b, sq, h, hd)


ONLINE_THRESHOLD = 2048      # use online softmax when Sq·Skv exceeds this²
KV_BLOCK = 1024


def _kv_mask(sq, skv, q_offset, window, is_causal, device, lo=0):
    """The (Sq, Skv) or per-row (B, Sq, Skv) mask of keys lo..lo+skv−1,
    as the reference's online path builds it: causal (k ≤ q) when
    ``is_causal``, and k > q − window whenever a window is given."""
    if is_causal:
        return causal_mask(sq, skv, q_offset - lo, device, window)
    q = torch.arange(sq, device=device)[:, None] - lo
    q = q + (q_offset.reshape(-1, 1, 1) if torch.is_tensor(q_offset)
             else q_offset)
    keys = torch.arange(skv, device=device)
    return (keys > q - window) if window is not None else \
        torch.ones_like(keys <= q)


def _sdpa_online(q, k, v, cap, scale, *, q_offset, window=None,
                 is_causal=True, key_lo=0, merge=None):
    """Flash-style online-softmax attention: a loop over KV blocks carrying
    (running max, normalizer, weighted accumulator).  Peak live buffer is
    O(Sq · KV_BLOCK) instead of O(Sq · Skv).  ``q_offset`` is an int or a
    (B,) tensor of per-row offsets; every block is masked by causality and
    by ``window`` (None = global), as the reference masks it.  ``k``/``v``
    hold the keys at positions ``key_lo`` onwards; with ``merge`` (a
    mesh) they are this data rank's share of every rank's keys, and the
    triple is merged over ``data`` before it is normalised."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, sq, kvh, rep, hd)
    kv_block = max(KV_BLOCK, ((skv // 8) + 127) // 128 * 128)
    nb = -(-skv // kv_block)
    dev = q.device
    m = torch.full((b, kvh, rep, sq), -1e30, device=dev)
    l = torch.zeros((b, kvh, rep, sq), device=dev)
    acc = torch.zeros((b, kvh, rep, sq, hd), device=dev)
    for bi in range(nb):
        lo, hi = bi * kv_block, min(skv, (bi + 1) * kv_block)
        msk = _kv_mask(sq, hi - lo, q_offset, window, is_causal, dev,
                       key_lo + lo)
        msk = msk.reshape((-1,) + msk.shape[-2:])              # (B|1,Sq,kv)
        s_blk = torch.einsum("bqgrd,bkgd->bgrqk", qg, k[:, lo:hi]).float()
        s_blk = softcap(s_blk * scale, cap)
        s_blk = s_blk.masked_fill(~msk[:, None, None], -1e30)
        m_new = torch.maximum(m, s_blk.amax(-1))
        p = torch.exp(s_blk - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(v.dtype), v[:, lo:hi])
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    if merge is not None:
        # a rank whose keys are all masked holds m = -1e30: corr = 0
        corr = torch.exp(m - merge.pmax(m.clone(), "data"))
        both = merge.psum(torch.cat([acc * corr[..., None],
                                     (l * corr)[..., None]], -1), "data")
        acc, l = both[..., :-1], both[..., -1]
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(v.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


def composed(q, k, v, *, scale, q_offset=0, window=None, is_causal=True,
             cap=None):
    """The composed path of one unsplit call: ``_sdpa`` on the whole
    (Sq, Skv) mask, or ``_sdpa_online`` over KV blocks where Sq·Skv
    exceeds ``ONLINE_THRESHOLD``².  Both apply ``window`` whenever it is
    given (``attention`` drops it for a non-causal dense call, as the
    reference does).  What ``ops.attention_fwd`` is held to on the
    card."""
    sq, skv = q.shape[1], k.shape[1]
    if sq * skv > ONLINE_THRESHOLD ** 2:
        return _sdpa_online(q, k, v, cap, scale, q_offset=q_offset,
                            window=window, is_causal=is_causal)
    mask = _kv_mask(sq, skv, q_offset, window, is_causal, q.device)
    return _sdpa(q, k, v, mask, cap, scale)


#: calls of ``attention`` on CUDA tensors that took the composed path (the
#: fused kernel's calls count under ``kernels/attention/launches``); a CPU
#: call has no kernel to miss and counts nowhere, as it launches none
COMPOSED = "models/attention/composed"


def kernel_takes(q, k, v, cache_pos, merged: bool) -> bool:
    """Whether the fused kernel takes a call, its device aside: f32 q, k,
    v that need no gradient (not under grad mode with an input that
    requires one: training, and its remat recomputation, keep the
    composed path, which has the backward), an int cursor or none (per-row
    tensor cursors keep the composed path), no sequence-split merge over
    ``data``, a head size the kernel is built for, and at least one query
    tile (one-token decode steps keep the composed path)."""
    return (all(t.dtype == torch.float32 for t in (q, k, v))
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (q, k, v)))
            and not torch.is_tensor(cache_pos) and not merged
            and q.shape[-1] in ATK.HEAD_DIMS and q.shape[1] >= ATK.Q_TILE)


def split_slots(cache_pos, s: int, smax: int, mesh) -> tuple:
    """(q_offset, cols, src, key_lo) of a step of ``s`` tokens at the int
    ``cache_pos`` into a cache whose ``smax`` positions are this data
    rank's share of smax·D: the local slice it writes, the slice of the
    step's tokens that lands there (empty where the rank owns none of
    them), and the global position of its first key.  The write start is
    clamped into the global cache as `cache_slots` clamps it."""
    if torch.is_tensor(cache_pos):
        raise NotImplementedError(
            "per-row cursors with sequence-split caches: every row of the "
            "batch is at one position")
    key_lo = mesh.axis_index("data") * smax
    q_offset = int(cache_pos)
    start = min(max(q_offset, 0), smax * mesh.extent("data") - s)
    lo = min(max(start, key_lo), key_lo + smax)
    hi = max(min(start + s, key_lo + smax), lo)
    return (q_offset, slice(lo - key_lo, hi - key_lo),
            slice(lo - start, hi - start), key_lo)


def cache_slots(cache_pos, b: int, s: int, smax: int, device):
    """(q_offset, rows, cols): the query offset of a step of ``s`` tokens
    at ``cache_pos`` (an int, or a (B,) tensor of per-row cursors) and the
    index that writes its entries into a (B, smax, ...) cache, the start
    clamped into the cache as ``dynamic_update_slice`` clamps it.  An int
    cursor stays on the host."""
    last = smax - s
    if torch.is_tensor(cache_pos):
        q_offset = cache_pos.reshape(-1).expand(b)
        rows = torch.arange(b, device=device)[:, None]
        cols = (q_offset.clamp(0, last)[:, None]
                + torch.arange(s, device=device))
        return q_offset, rows, cols
    q_offset = int(cache_pos)
    start = min(max(q_offset, 0), last)
    return q_offset, slice(None), slice(start, start + s)


def attention(p, x, cfg, positions, *, window=None, is_causal=True,
              cache=None, cache_pos=None, kv_override=None,
              seq_split=False):
    """Returns (out, cache).  ``p`` holds wq/wk/wv/wo.

    positions: (S,) or per row (B, S).  window: the sliding window of a
    local layer (None = global; the reference's ``1 << 30`` masks the
    same).  cache: dict(k=(B,Smax,KV,hd), v=…), written in place at
    ``cache_pos`` (an int or a (B,) tensor of per-row cursors; the write
    start is clamped into the cache as ``dynamic_update_slice`` clamps
    it).  kv_override: precomputed (k, v) of shape (B, Skv, KV, hd)
    (cross-attention): q is not rotated, every key is attended, and no
    cache is written.

    The head counts come from the weights' widths: under a mesh with a
    ``model`` extent M > 1 (`models/shardings.py`), ``p`` holds the rank's
    column blocks of wq/wk/wv (its query heads and the KV heads they
    read) and its row block of wo, whose partial product is summed over
    ``model``; ``x`` enters that split region through `shardings.
    tp_enter`.  ``seq_split``: the cache (or ``kv_override``) holds this
    data rank's share of the positions (module docstring).
    """
    b, s, d = x.shape
    hd = cfg.hd
    x = SH.tp_enter(x)
    q = (x @ p.wq).reshape(b, s, -1, hd)
    if kv_override is None:
        k = (x @ SH.tp_enter_kv(p.wk, cfg)).reshape(b, s, -1, hd)
        v = (x @ SH.tp_enter_kv(p.wv, cfg)).reshape(b, s, -1, hd)
        cos, sin = rope_freqs(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    else:
        k, v = kv_override
        is_causal = False
    q_offset, key_lo = 0, 0
    mesh = SH.current_mesh() if seq_split else None
    if cache is not None and kv_override is None:
        if seq_split:
            q_offset, cols, src, key_lo = split_slots(
                cache_pos, s, cache["k"].shape[1], mesh)
            cache["k"][:, cols] = k[:, src].to(cache["k"].dtype)
            cache["v"][:, cols] = v[:, src].to(cache["v"].dtype)
        else:
            q_offset, rows, cols = cache_slots(cache_pos, b, s,
                                               cache["k"].shape[1], x.device)
            cache["k"][rows, cols] = k.to(cache["k"].dtype)
            cache["v"][rows, cols] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
    elif seq_split:
        key_lo = mesh.axis_index("data") * k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    merged = seq_split and mesh.extent("data") > 1
    if not (is_causal or merged or s * k.shape[1] > ONLINE_THRESHOLD ** 2):
        window = None   # the reference's dense path: causal masks only
    # (a split of one: the rank's keys are all the keys, key_lo = 0)
    if q.is_cuda and kernel_takes(q, k, v, cache_pos, merged):
        out = ops.attention_fwd(q, k, v, scale=scale, q_offset=q_offset,
                                window=window, is_causal=is_causal,
                                cap=cfg.attn_logit_softcap)
    else:
        if q.is_cuda:
            metrics.inc(COMPOSED)
        if merged:
            out = _sdpa_online(q, k, v, cfg.attn_logit_softcap, scale,
                               q_offset=q_offset, window=window,
                               is_causal=is_causal, key_lo=key_lo,
                               merge=mesh)
        else:
            out = composed(q, k, v, scale=scale, q_offset=q_offset,
                           window=window, is_causal=is_causal,
                           cap=cfg.attn_logit_softcap)
    return SH.tp_psum(out.reshape(b, s, -1) @ p.wo), cache


def init_cross_kv(p, enc_out, cfg) -> tuple:
    """Cross-attention K/V (B, F, KV, hd) from the encoder output (B, F,
    d) (whisper)."""
    b, f, _ = enc_out.shape
    enc_out = SH.tp_enter(enc_out)
    k = (enc_out @ SH.tp_enter_kv(p.wk, cfg)).reshape(b, f, -1, cfg.hd)
    v = (enc_out @ SH.tp_enter_kv(p.wv, cfg)).reshape(b, f, -1, cfg.hd)
    return k, v
