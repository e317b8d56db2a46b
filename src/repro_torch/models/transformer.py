"""The decoder assembler (port of ``repro/models/transformer.py``), hybrid
family only so far:

  hybrid — zamba2: a Mamba2 stack with ONE weight-shared attention+MLP
           block applied after every `attn_every` Mamba layers (its KV
           caches are per *application*).

The other families (dense, moe, ssm, audio, vlm) raise
`NotImplementedError`; they are ROADMAP queue 1 item 10.  Sharding
constraints are the identity on one card, and remat waits for training.

``forward`` runs with caches updated in place (the reference returns new
caches; here the returned dict is the one passed in).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.csr import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M2
from repro_torch.models.layers import (ParamTree, normal, rmsnorm, softcap,
                                       swiglu)


def _require_hybrid(cfg: ArchConfig) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"the port runs the hybrid family only; {cfg.name} is "
            f"{cfg.family!r} (ROADMAP.md queue 1 item 10)")
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of "
                         f"attn_every={cfg.attn_every}")


def _init_mlp(gen: torch.Generator, cfg, dtype) -> dict:
    return {
        "w_gate": normal(gen, (cfg.d_model, cfg.d_ff), 0.02, dtype),
        "w_up": normal(gen, (cfg.d_model, cfg.d_ff), 0.02, dtype),
        "w_down": normal(gen, (cfg.d_ff, cfg.d_model), 0.02, dtype),
    }


class MambaBlock(nn.Module):
    """Pre-norm residual Mamba2 layer: x + mixer(rmsnorm(x, ln1))."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        self.ln1 = nn.Parameter(tree["ln1"], requires_grad=False)
        self.mamba = M2.Mamba2(cfg, tree["mamba"])


class HybridLM(nn.Module):
    """zamba2: ``blocks`` (n_layers Mamba layers) and one ``shared``
    attention+MLP block; ``state_dict`` names follow the reference pytree
    (``blocks.<i>.mamba.in_proj`` for ``params["blocks"]["mamba"]
    ["in_proj"][i]``)."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        _require_hybrid(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.final_gamma = nn.Parameter(tree["final_gamma"],
                                        requires_grad=False)
        self.blocks = nn.ModuleList(MambaBlock(cfg, b)
                                    for b in tree["blocks"])
        self.shared = ParamTree(tree["shared"])

    def forward(self, tokens, caches=None, cache_pos=None,
                engine: Optional[str] = None):
        return forward(self, self.cfg, tokens, caches=caches,
                       cache_pos=cache_pos, engine=engine)


def init_params(cfg: ArchConfig, seed: int, dtype=torch.float32,
                device=None) -> HybridLM:
    """Random weights from ``seed``, drawn on ``device`` (None = CUDA;
    raises without a card unless ``device="cpu"``)."""
    _require_hybrid(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    tree = {
        "embed": normal(gen, (cfg.vocab_pad, d), 0.02, dtype),
        "final_gamma": zeros(d),
        "blocks": [{"ln1": zeros(d), "mamba": M2.init_mamba2(gen, cfg, dtype)}
                   for _ in range(cfg.n_layers)],
        "shared": {"ln1": zeros(d), "attn": A.init_attn(gen, cfg, dtype),
                   "ln2": zeros(d), "mlp": _init_mlp(gen, cfg, dtype)},
    }
    return HybridLM(cfg, tree)


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.float32, device=None) -> dict:
    """The reference's hybrid cache layout: ``attn.k/v`` (groups, B,
    max_len, kv, hd), ``ssm`` (layers, B, nh, N, P), ``conv`` (layers, B,
    K−1, C)."""
    _require_hybrid(cfg)
    dev = resolve_device(device)
    groups = cfg.n_layers // cfg.attn_every
    kv = (groups, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "attn": {"k": torch.zeros(kv, dtype=dtype, device=dev),
                 "v": torch.zeros(kv, dtype=dtype, device=dev)},
        "ssm": torch.zeros(cfg.n_layers, batch, cfg.ssm_nheads,
                           cfg.ssm_state, cfg.ssm_head_dim, device=dev),
        "conv": torch.zeros(cfg.n_layers, batch, cfg.ssm_conv - 1,
                            cfg.d_inner + 2 * cfg.ssm_state, dtype=dtype,
                            device=dev),
    }


def _run_hybrid(model: HybridLM, cfg, x, positions, caches, cache_pos,
                engine):
    """Groups of `attn_every` Mamba layers, each followed by the shared
    attention+MLP block."""
    every = cfg.attn_every
    sh = model.shared
    for g in range(cfg.n_layers // every):
        for i in range(g * every, (g + 1) * every):
            blk = model.blocks[i]
            st = None if caches is None else {"ssm": caches["ssm"][i],
                                              "conv": caches["conv"][i]}
            y, new_st = blk.mamba(rmsnorm(x, blk.ln1, cfg.norm_eps),
                                  state=st, engine=engine)
            if new_st is not None:
                st["ssm"].copy_(new_st["ssm"])
                st["conv"].copy_(new_st["conv"])
            x = x + y
        kv = None if caches is None else {"k": caches["attn"]["k"][g],
                                          "v": caches["attn"]["v"][g]}
        a, _ = A.attention(sh.attn, rmsnorm(x, sh.ln1, cfg.norm_eps), cfg,
                           positions, cache=kv, cache_pos=cache_pos)
        x = x + a
        h2 = rmsnorm(x, sh.ln2, cfg.norm_eps)
        x = x + swiglu(h2, sh.mlp.w_gate, sh.mlp.w_up, sh.mlp.w_down)
    return x


@torch.no_grad()
def forward(model: HybridLM, cfg: ArchConfig, tokens, *, caches=None,
            cache_pos=None, engine: Optional[str] = None):
    """Returns (logits, caches).

    tokens: (B, S) integer.  caches + cache_pos (an int or a (B,) tensor of
    per-row cursors) → decode mode, one token per row (S == 1), caches
    updated in place.  ``engine`` picks the Mamba2 scan of the
    full-sequence path (None: the CUDA kernel on a CUDA model, the chunked
    torch path on the CPU).
    """
    _require_hybrid(cfg)
    tokens = torch.as_tensor(tokens, device=model.embed.device)
    x = model.embed[tokens] * math.sqrt(cfg.d_model)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device)[None]
    if torch.is_tensor(cache_pos):
        positions = cache_pos.reshape(-1, 1) + positions
    elif cache_pos is not None:
        positions = positions + int(cache_pos)
    positions = positions.expand(b, s)
    x = _run_hybrid(model, cfg, x, positions, caches, cache_pos, engine)
    x = rmsnorm(x, model.final_gamma, cfg.norm_eps)
    logits = x @ model.embed.T
    return softcap(logits.float(), cfg.final_logit_softcap), caches
