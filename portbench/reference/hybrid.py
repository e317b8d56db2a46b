"""The hybrid Mamba2 stack (zamba2-2.7B as the repository states it):
pre-norm Mamba2 layers, and after every ``attn_every`` of them one
weight-shared block of causal attention and a SwiGLU MLP; the embedding
scaled by √d, a final RMS norm, the head tied to the embedding.  The
published model's two alternating shared blocks, their LoRA adapters and
the concatenated embedding input are not part of the repository's model
and are left out here too.

A Mamba2 layer: ``in_proj`` gives z, the conv channels (x, B, C) and one
dt per head; a causal depthwise conv of width K and SiLU over (x, B, C);
dt ← softplus(dt + dt_bias); the scan

    h_t = exp(A·dt_t) h_{t−1} + dt_t · B_t x_tᵀ,   y_t = C_t h_t + D x_t

per head (A = −exp(a_log); B and C shared by every head); the gated norm
rmsnorm(y · silu(z)) and ``out_proj``.  The scan is computed in chunks of
`CHUNK` steps: within a chunk as masked products, across chunks by
carrying the state (`ssd`).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from portbench.reference import common as C

CHUNK = 64


def spec(cfg: dict) -> list:
    d, f, n = cfg["d_model"], cfg["d_ff"], cfg["ssm_state"]
    di = cfg["ssm_expand"] * d
    nh = di // cfg["ssm_head_dim"]
    conv = di + 2 * n
    hd = d // cfg["n_heads"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    w = ("normal", 0.02)
    gain = ("normal", 0.02)
    rows = [("embed", "embed", (C.vocab_pad(cfg), d), w)]
    for i in range(cfg["n_layers"]):
        g, p = f"layer{i}", f"blocks.{i}."
        m = p + "mamba."
        rows += [(g, p + "ln1", (d,), gain),
                 (g, m + "in_proj", (d, 2 * di + 2 * n + nh), w),
                 (g, m + "conv_w", (cfg["ssm_conv"], conv), ("normal", 0.2)),
                 (g, m + "conv_b", (conv,), ("normal", 0.02)),
                 (g, m + "a_log", (nh,), ("log_uniform", 1.0, 16.0)),
                 (g, m + "dt_bias", (nh,),
                  ("inv_softplus_log_uniform", 1e-3, 1e-1)),
                 (g, m + "d_skip", (nh,), ("one_plus", 0.1)),
                 (g, m + "gate_gamma", (di,), gain),
                 (g, m + "out_proj", (di, d), w)]
    s = "shared."
    rows += [("shared", s + "ln1", (d,), gain),
             ("shared", s + "attn.wq", (d, q), w),
             ("shared", s + "attn.wk", (d, kv), w),
             ("shared", s + "attn.wv", (d, kv), w),
             ("shared", s + "attn.wo", (q, d), w),
             ("shared", s + "ln2", (d,), gain),
             ("shared", s + "mlp.w_gate", (d, f), w),
             ("shared", s + "mlp.w_up", (d, f), w),
             ("shared", s + "mlp.w_down", (f, d), w),
             ("final", "final_gamma", (d,), gain)]
    return rows


def no_decay(cfg: dict) -> set:
    """The unstacked gains: the final norm's and the shared block's."""
    return {"final_gamma", "shared.ln1", "shared.ln2"}


def ssd(x, dt, a, bm, cm):
    """x (B, L, H, P), dt (B, L, H), a (H,) negative, bm and cm (B, L, N)
    → y (B, L, H, P) of h_t = exp(a·dt_t) h_{t−1} + dt_t B_t x_tᵀ,
    y_t = C_t h_t, from h_0 = 0."""
    b, seq, nh, p = x.shape
    n = bm.shape[-1]
    pad = (-seq) % CHUNK
    if pad:                     # zero steps: decay 1, no input
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    nc = x.shape[1] // CHUNK
    xd = (x * dt[..., None]).view(b, nc, CHUNK, nh, p)
    logd = (dt * a).view(b, nc, CHUNK, nh)
    cum = logd.cumsum(2)                                   # (B, c, t, H)
    bc, cc = bm.view(b, nc, CHUNK, n), cm.view(b, nc, CHUNK, n)
    # within a chunk: y_t += Σ_{u≤t} (C_t·B_u) exp(cum_t − cum_u) dt_u x_u
    keep = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=x.device).tril()
    gap = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        ~keep[:, :, None], float("-inf"))                  # (B, c, t, u, H)
    cb = C.einsum("bctn,bcun->bctu", cc, bc)
    y = C.einsum("bctuh,bcuhp->bcthp", cb[..., None] * gap.exp(), xd)
    # each chunk's own contribution to the state at its end
    tail = (cum[:, :, -1:, :] - cum).exp()                 # (B, c, u, H)
    own = C.einsum("bcun,bcuhp->bchnp", bc,
                   xd * tail[..., None])                   # (B, c, H, N, P)
    # the state entering each chunk, carried across chunks
    whole = cum[:, :, -1, :].exp()                         # (B, c, H)
    h = torch.zeros(b, nh, n, p, device=x.device, dtype=x.dtype)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = whole[:, c, :, None, None] * h + own[:, c]
    hin = torch.stack(entering, 1)                         # (B, c, H, N, P)
    y = y + C.einsum("bctn,bchnp->bcthp", cc, hin) * cum.exp()[..., None]
    return y.reshape(b, nc * CHUNK, nh, p)[:, :seq]


def mamba(w: dict, pre: str, h: torch.Tensor, cfg: dict) -> torch.Tensor:
    b, seq, d = h.shape
    n, p, k = cfg["ssm_state"], cfg["ssm_head_dim"], cfg["ssm_conv"]
    di = cfg["ssm_expand"] * d
    nh = di // p
    proj = C.mm(h, w[pre + "in_proj"])
    z, xbc, dt = proj.split([di, di + 2 * n, nh], -1)
    past = F.pad(xbc, (0, 0, k - 1, 0))                    # causal: zeros before
    conv = sum(w[pre + "conv_w"][j] * past[:, j:j + seq] for j in range(k))
    xbc = F.silu(conv + w[pre + "conv_b"])
    xs, bm, cm = xbc.split([di, n, n], -1)
    dt = F.softplus(dt + w[pre + "dt_bias"])
    xh = xs.view(b, seq, nh, p)
    y = ssd(xh, dt, -w[pre + "a_log"].exp(), bm, cm)
    y = y + w[pre + "d_skip"][:, None] * xh
    y = C.rmsnorm(y.reshape(b, seq, di) * F.silu(z), w[pre + "gate_gamma"],
                  cfg["norm_eps"])
    return C.mm(y, w[pre + "out_proj"])


def _mamba_layer(w, i, cfg, x):
    p = f"blocks.{i}."
    return x + mamba(w, p + "mamba.", C.rmsnorm(x, w[p + "ln1"], cfg["norm_eps"]),
                     cfg)


def _shared(w, cfg, x):
    eps = cfg["norm_eps"]
    x = x + C.causal_attention(w, "shared.attn.",
                               C.rmsnorm(x, w["shared.ln1"], eps), cfg)
    return x + C.swiglu(w, "shared.mlp.", C.rmsnorm(x, w["shared.ln2"], eps))


def forward(w: dict, cfg: dict, tokens: torch.Tensor, remat: bool = False):
    """tokens (B, L) → logits (B, L, vocab_pad), float32."""
    def run(body, x):
        return (checkpoint.checkpoint(body, x, use_reentrant=False) if remat
                else body(x))

    x = w["embed"][tokens] * math.sqrt(cfg["d_model"])
    every = cfg["attn_every"]
    for i in range(cfg["n_layers"]):
        x = run(functools.partial(_mamba_layer, w, i, cfg), x)
        if (i + 1) % every == 0:
            x = run(functools.partial(_shared, w, cfg), x)
    x = C.rmsnorm(x, w["final_gamma"], cfg["norm_eps"])
    return C.mm(x, w["embed"].T)
