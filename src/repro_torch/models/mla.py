"""Multi-head Latent Attention (port of ``repro/models/mla.py``; DeepSeek-V2,
arXiv:2405.04434).

K/V are up-projected from a shared compressed latent c_kv (kv_lora wide)
plus one shared RoPE key head; Q comes through its own low-rank path
(q_lora).  The decode cache stores only (c_kv, k_rope): (kv_lora +
rope_hd) floats per token per layer instead of 2·H·hd.

As in the port's `attention`, ``cache_pos`` is an int or a (B,) tensor
of per-row cursors (the batcher decodes every slot in one call), and the
cache is written in place.  The head count comes from the weights'
widths: under a mesh with a ``model`` extent M > 1 (`models/shardings.py`)
``p`` holds the rank's heads of wuq/wuk/wuv and its rows of wo, whose
partial product is summed over ``model``; the latent path (wdq, wdkv,
wkr) and the ``ckv``/``kr`` cache are whole on every rank, and the
latent activations enter the split heads through `shardings.tp_enter`.
With ``seq_split`` (context parallelism, `models/attention.py`) each
data rank holds its share of the ``ckv``/``kr`` positions, writes only
those, scores its own keys, and the softmax is merged over ``data``
(`_split_softmax`), in the absorbed step and the full path alike.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import shardings as SH
from repro_torch.models.attention import cache_slots, split_slots
from repro_torch.models.layers import (apply_rope, causal_mask, normal,
                                       rmsnorm, rope_freqs)


def init_mla(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    qk = cfg.nope_head_dim + cfg.rope_head_dim
    h = cfg.n_heads
    return {
        "wdq": normal(gen, (d, cfg.q_lora), 0.02, dtype),
        "q_gamma": torch.zeros(cfg.q_lora, dtype=dtype, device=gen.device),
        "wuq": normal(gen, (cfg.q_lora, h * qk), 0.02, dtype),
        "wdkv": normal(gen, (d, cfg.kv_lora), 0.02, dtype),
        "kv_gamma": torch.zeros(cfg.kv_lora, dtype=dtype, device=gen.device),
        "wkr": normal(gen, (d, cfg.rope_head_dim), 0.02, dtype),
        "wuk": normal(gen, (cfg.kv_lora, h * cfg.nope_head_dim), 0.02, dtype),
        "wuv": normal(gen, (cfg.kv_lora, h * cfg.v_head_dim), 0.02, dtype),
        "wo": normal(gen, (h * cfg.v_head_dim, d), 0.02, dtype),
    }


def _split_softmax(logits, mesh, weigh):
    """The softmax over every data rank's keys of ``logits`` (this rank's
    keys, masked), applied by ``weigh(w)`` (a weighted sum over the keys'
    dim, which must keep the (b, h, q) dims in order at 0, 2, 1): each
    rank's exp-weights from the global max, their sums merged by psum."""
    mx = mesh.pmax(logits.amax(-1, keepdim=True).contiguous(), "data")
    w = torch.exp(logits - mx)
    den = mesh.psum(w.sum(-1).contiguous(), "data")          # (b, h, q)
    num = mesh.psum(weigh(w).contiguous(), "data")           # (b, q, h, ·)
    return num / den.transpose(1, 2)[..., None]


def mla_attention(p, x, cfg, positions, cache=None, cache_pos=None,
                  seq_split=False):
    """Returns (out, cache); cache = dict(ckv=(B,Smax,kv_lora),
    kr=(B,Smax,rope_hd)), written in place at ``cache_pos``.

    A one-token step with a cache runs with the up-projections absorbed
    into the query and the output: attention works in the kv_lora space
    and never builds the (Smax, h, dn) keys or (Smax, h, dv) values."""
    b, s, _ = x.shape
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    h = p.wuk.shape[1] // dn
    cq = SH.tp_enter(rmsnorm(x @ p.wdq, p.q_gamma, cfg.norm_eps))
    q = (cq @ p.wuq).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv = SH.tp_enter(rmsnorm(x @ p.wdkv, p.kv_gamma, cfg.norm_eps))
    kr = SH.tp_enter((x @ p.wkr).reshape(b, s, 1, dr))
    cos, sin = rope_freqs(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    kr = apply_rope(kr, cos, sin)
    key_lo, mesh = 0, SH.current_mesh() if seq_split else None
    merge = seq_split and mesh.extent("data") > 1
    if cache is not None:
        if seq_split:
            q_offset, cols, src, key_lo = split_slots(
                cache_pos, s, cache["ckv"].shape[1], mesh)
            rows = slice(None)
        else:
            q_offset, rows, cols = cache_slots(cache_pos, b, s,
                                               cache["ckv"].shape[1],
                                               x.device)
            src = slice(None)
        cache["ckv"][rows, cols] = ckv[:, src].to(cache["ckv"].dtype)
        cache["kr"][rows, cols] = kr[:, src, 0].to(cache["kr"].dtype)
        ckv_all, kr_all = cache["ckv"], cache["kr"][:, :, None]
    else:
        q_offset = 0
        ckv_all, kr_all = ckv, kr
    kv_len = ckv_all.shape[1]
    mask = causal_mask(s, kv_len, q_offset - key_lo, x.device)
    mask = mask.reshape((-1, 1) + mask.shape[-2:])          # (B|1,1,Sq,kv)
    scale = 1.0 / math.sqrt(dn + dr)
    if s == 1 and cache is not None:
        wuk = p.wuk.reshape(cfg.kv_lora, h, dn)
        wuv = p.wuv.reshape(cfg.kv_lora, h, dv)
        q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope, wuk)   # (b,1,h,lora)
        logits = (torch.einsum("bqhl,bkl->bhqk", q_abs, ckv_all)
                  + torch.einsum("bqhd,bkod->bhqk", q_rope, kr_all)
                  ).float() * scale
        logits = logits.masked_fill(~mask, -1e30)
        if merge:
            ctx = _split_softmax(logits, mesh, lambda w: torch.einsum(
                "bhqk,bkl->bqhl", w.to(ckv_all.dtype), ckv_all))
        else:
            w = torch.softmax(logits, -1).to(ckv_all.dtype)
            ctx = torch.einsum("bhqk,bkl->bqhl", w, ckv_all)   # (b,1,h,lora)
        out = torch.einsum("bqhl,lhd->bqhd", ctx, wuv).reshape(b, s, h * dv)
        return SH.tp_psum(out @ p.wo), cache
    k_nope = (ckv_all @ p.wuk).reshape(b, kv_len, h, dn)
    v = (ckv_all @ p.wuv).reshape(b, kv_len, h, dv)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkod->bhqk", q_rope, kr_all)
              ).float() * scale
    logits = logits.masked_fill(~mask, -1e30)
    if merge:
        out = _split_softmax(logits, mesh, lambda w: torch.einsum(
            "bhqk,bkhd->bqhd", w.to(v.dtype), v)).reshape(b, s, h * dv)
    else:
        w = torch.softmax(logits, -1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, h * dv)
    return SH.tp_psum(out @ p.wo), cache
