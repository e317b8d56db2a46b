"""Pipeline-stage assignment via the paper's partitioner (port of
``repro/train/pipeline.py``; DESIGN.md §3).

The layer dependency graph is a weighted chain: node weight = per-layer
FLOPs, edge weight = activation bytes crossing the stage boundary.  KaFFPa
with enforce_balance (ε→0, KaBaPE feasibility guarantee) partitions it
on the port's kaffpa (kernel 1 on the card); the stages returned are the
reference's monotone sweep (chains partition into intervals optimally
among contiguous solutions), so they equal the reference's exactly.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.csr import Graph
from repro_torch.core.kaffpa import kaffpa


def layer_costs(cfg: ArchConfig, seq_len: int) -> tuple:
    """(flops_per_layer, act_bytes_between_layers): per token simplified."""
    d = cfg.d_model
    if cfg.is_moe:
        dff = (cfg.d_ff_expert or cfg.d_ff)
        ff = 6 * d * dff * (cfg.top_k + cfg.n_shared_experts)
    else:
        ff = 6 * d * cfg.d_ff
    attn = 8 * d * d + 4 * d * seq_len        # proj + scores (causal avg)
    fl = np.full(cfg.n_layers, ff + attn, dtype=np.float64)
    act = np.full(cfg.n_layers - 1, 2 * d, dtype=np.float64)  # bf16 resid
    return fl, act


def partition_layers(cfg: ArchConfig, n_stages: int, seq_len: int = 4096,
                     seed: int = 0, device=None) -> np.ndarray:
    """stage[i] = pipeline stage of layer i (contiguous, balanced).
    kaffpa runs on ``device`` (None = CUDA; raises without a card unless
    ``device="cpu"``)."""
    fl, act = layer_costs(cfg, seq_len)
    l = cfg.n_layers
    if n_stages <= 1:
        return np.zeros(l, dtype=np.int64)
    scale = max(1.0, fl.max() / 10_000)
    g = Graph.from_edges(l, np.arange(l - 1), np.arange(1, l),
                         np.maximum((act / act.max() * 100), 1).astype(np.int64),
                         vwgt=np.maximum(fl / scale, 1).astype(np.int64))
    # the reference partitions the chain, then returns the sweep below
    kaffpa(g, n_stages, 0.03, "fast", seed=seed, enforce_balance=True,
           device=device)
    # contiguity: sweep layers in order, open a new stage when the balanced
    # budget is used up; stage ids follow layer order
    budget = fl.sum() / n_stages
    stage = np.zeros(l, dtype=np.int64)
    acc, s = 0.0, 0
    for i in range(l):
        if acc + fl[i] > budget * 1.05 and s < n_stages - 1:
            s += 1
            acc = 0.0
        stage[i] = s
        acc += fl[i]
    return stage
