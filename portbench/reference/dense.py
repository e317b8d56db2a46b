"""The dense decoder (minicpm-2B as the repository states it): pre-norm
blocks of causal multi-head attention with rotary positions and a SwiGLU
MLP, the embedding scaled by √d, a final RMS norm and the head tied to
the embedding.  MiniCPM's µP scalings (scale_emb, scale_depth, the logit
divisor) are not part of the repository's model and are left out here
too."""
from __future__ import annotations

import functools
import math

import torch
from torch.utils import checkpoint

from portbench.reference import common as C


def spec(cfg: dict) -> list:
    d, f = cfg["d_model"], cfg["d_ff"]
    hd = d // cfg["n_heads"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    w = ("normal", 0.02)
    gain = ("normal", 0.02)
    rows = [("embed", "embed", (C.vocab_pad(cfg), d), w)]
    for i in range(cfg["n_layers"]):
        g, p = f"layer{i}", f"blocks.{i}."
        rows += [(g, p + "ln1", (d,), gain),
                 (g, p + "attn.wq", (d, q), w), (g, p + "attn.wk", (d, kv), w),
                 (g, p + "attn.wv", (d, kv), w), (g, p + "attn.wo", (q, d), w),
                 (g, p + "ln2", (d,), gain),
                 (g, p + "mlp.w_gate", (d, f), w), (g, p + "mlp.w_up", (d, f), w),
                 (g, p + "mlp.w_down", (f, d), w)]
    rows.append(("final", "final_gamma", (d,), gain))
    if not cfg["tie_embeddings"]:
        rows.append(("head", "lm_head", (d, C.vocab_pad(cfg)), w))
    return rows


def no_decay(cfg: dict) -> set:
    """The final norm's gain; every per-layer leaf is decayed (the
    configuration's optimizer decays leaves stacked over the layers)."""
    return {"final_gamma"}


def _block(w: dict, i: int, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    p, eps = f"blocks.{i}.", cfg["norm_eps"]
    x = x + C.causal_attention(w, p + "attn.", C.rmsnorm(x, w[p + "ln1"], eps), cfg)
    return x + C.swiglu(w, p + "mlp.", C.rmsnorm(x, w[p + "ln2"], eps))


def forward(w: dict, cfg: dict, tokens: torch.Tensor, remat: bool = False):
    """tokens (B, L) → logits (B, L, vocab_pad), float32."""
    x = w["embed"][tokens] * math.sqrt(cfg["d_model"])
    for i in range(cfg["n_layers"]):
        body = functools.partial(_block, w, i, cfg)
        x = (checkpoint.checkpoint(body, x, use_reentrant=False) if remat
             else body(x))
    x = C.rmsnorm(x, w["final_gamma"], cfg["norm_eps"])
    head = w["embed"].T if cfg["tie_embeddings"] else w["lm_head"]
    return C.mm(x, head)
