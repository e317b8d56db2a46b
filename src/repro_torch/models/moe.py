"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``; deepseek-v2:
2 shared + 160 routed top-6, llama4-scout: shared + 16 routed top-1).

Sort-based capacity dispatch as in GShard/Switch: (token, choice) pairs
are sorted by expert, scattered into per-expert capacity buffers
(E, cap, d), run through three batched expert matmuls and gathered back;
pairs beyond an expert's capacity are dropped.  The capacity rule, the
stable sort and the top-k are the reference's, so both packages drop
the same tokens.

Expert placement partitions the expert co-activation graph with the
port's own kaffpa (node+edge balanced, on the card unless
``device="cpu"``), the paper's program applied to the model stack.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamTree, normal, swiglu

# ---------------------------------------------------------------------------
# gate observation
# ---------------------------------------------------------------------------

#: When set, every ``moe_ffn`` call reports its routed expert indices
#: (host numpy, shape (T, k)).
_gate_observer = None


def _emit_gates(gate_idx: torch.Tensor) -> None:
    """Tap the routing decision: with no observer installed nothing is
    copied and nothing waits for the card; with one, one copy to the host
    per call."""
    fn = _gate_observer
    if fn is not None:
        fn(gate_idx.cpu().numpy())


@contextlib.contextmanager
def observe_gates(sink):
    """Install a gate observer for the duration of the context.

    ``sink`` is either a callable taking a (T, k) int array or an object
    with an ``observe`` method."""
    global _gate_observer
    fn = sink.observe if hasattr(sink, "observe") else sink
    prev = _gate_observer
    _gate_observer = fn
    try:
        yield sink
    finally:
        _gate_observer = prev


def init_moe(gen: torch.Generator, cfg, dtype) -> dict:
    d = cfg.d_model
    dff = cfg.d_ff_expert or cfg.d_ff
    e = cfg.n_experts
    p = {
        "router": normal(gen, (d, e), 0.02, torch.float32),
        "w_gate": normal(gen, (e, d, dff), 0.02, dtype),
        "w_up": normal(gen, (e, d, dff), 0.02, dtype),
        "w_down": normal(gen, (e, dff, d), 0.02, dtype),
    }
    if cfg.n_shared_experts:
        sdff = cfg.n_shared_experts * dff
        p.update({
            "ws_gate": normal(gen, (d, sdff), 0.02, dtype),
            "ws_up": normal(gen, (d, sdff), 0.02, dtype),
            "ws_down": normal(gen, (sdff, d), 0.02, dtype),
        })
    return p


def capacity(t: int, cfg) -> int:
    """Per-expert capacity of a dispatch group of ``t`` tokens (the
    reference's rule, its round-up to 512 at t >= 4096 included)."""
    cap = max(1, int(math.ceil(t * cfg.top_k * cfg.capacity_factor
                               / cfg.n_experts)))
    if t >= 4096:
        cap = int(math.ceil(cap / 512) * 512)
    return cap


def moe_ffn(p, x: torch.Tensor, cfg, per_row: bool = False) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d).

    The B·S tokens dispatch as one group, as in the reference, unless
    ``per_row``: then each batch row is a group of its S tokens with its
    own capacity.  The batched decode asks for that, because the
    reference decodes each slot in its own call."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g, t = (b, s) if per_row else (1, b * s)
    dev = x.device
    xt = x.reshape(g, t, d)
    logits = (xt.to(p.router.dtype) @ p.router).float()          # (G,T,E)
    gate_vals, gate_idx = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    _emit_gates(gate_idx.reshape(-1, k))
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = capacity(t, cfg)
    # flatten (token, choice) pairs and sort them by expert, stably
    pair_e = gate_idx.reshape(g, t * k)
    order = torch.argsort(pair_e, dim=-1, stable=True)
    pe = torch.gather(pair_e, 1, order)
    pt = torch.arange(t, device=dev).repeat_interleave(k)[order]
    pg = torch.gather(gate_vals.reshape(g, t * k), 1, order)
    # position within the expert's group = index − its first index
    first = torch.searchsorted(
        pe, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos = torch.arange(t * k, device=dev) - torch.gather(first, 1, pe)
    keep = pos < cap
    slot = torch.where(keep, pe * cap + pos, 0)                   # drop → w=0
    rows = torch.arange(g, device=dev)[:, None].expand_as(slot)
    val = torch.where(keep[..., None], xt[rows, pt], 0.0)
    buf = xt.new_zeros(g, e * cap, d).index_put_((rows, slot), val,
                                                 accumulate=True)
    expert_in = buf.reshape(g, e, cap, d).transpose(0, 1) \
        .reshape(e, g * cap, d)
    h = F.silu(expert_in @ p.w_gate) * (expert_in @ p.w_up)
    expert_out = (h @ p.w_down).reshape(e, g, cap, d).transpose(0, 1) \
        .reshape(g, e * cap, d)
    contrib = torch.where(keep[..., None],
                          expert_out[rows, slot] * pg[..., None].to(x.dtype),
                          0.0)
    y = xt.new_zeros(g, t, d).index_put_((rows, pt), contrib,
                                         accumulate=True)
    if cfg.n_shared_experts:
        y = y + swiglu(xt, p.ws_gate, p.ws_up, p.ws_down)
    return y.reshape(b, s, d)


#: The expert-parallel form: on one card it is ``moe_ffn``.  The
#: all-to-all over a mesh of several ranks waits for ``shardings.py``.
moe_ffn_a2a = moe_ffn


# ---------------------------------------------------------------------------
# KaHIP-driven expert placement
# ---------------------------------------------------------------------------

def coactivation_graph(gate_idx: np.ndarray, n_experts: int,
                       load: Optional[np.ndarray] = None):
    """The expert co-activation graph of routing decisions.

    gate_idx: (T, k) int, per token its routed experts.  Edge (a, b)
    weight = the number of tokens routed to both; node weight = the
    expert's load."""
    from repro_torch.core.csr import Graph
    gate_idx = np.asarray(gate_idx)
    _, k = gate_idx.shape
    cnt = np.zeros((n_experts, n_experts), dtype=np.int64)
    for i in range(k):
        for j in range(i + 1, k):
            np.add.at(cnt, (gate_idx[:, i], gate_idx[:, j]), 1)
    cnt = cnt + cnt.T
    if load is None:
        load = np.bincount(gate_idx.reshape(-1), minlength=n_experts)
    u, v = np.triu_indices(n_experts, 1)
    w = cnt[u, v]
    keep = w > 0
    return Graph.from_edges(n_experts, u[keep], v[keep], w[keep],
                            vwgt=np.maximum(load, 1))


def expert_placement(gate_idx: np.ndarray, n_experts: int, n_shards: int,
                     seed: int = 0, device=None) -> np.ndarray:
    """Partition the experts into shards (node+edge balanced kaffpa on
    ``device``, None = CUDA) and return a permutation: perm[new_slot] =
    old_expert_id, the slots contiguous per shard."""
    from repro_torch.core.kaffpa import kaffpa
    g = coactivation_graph(gate_idx, n_experts)
    part = kaffpa(g, n_shards, 0.03, "fast", seed=seed, balance_edges=True,
                  enforce_balance=False, device=device)
    per = n_experts // n_shards
    # exact-size packing: overflow experts spill to underfull shards
    order = []
    buckets = [list(np.flatnonzero(part == s)) for s in range(n_shards)]
    spill = []
    for s in range(n_shards):
        if len(buckets[s]) > per:
            spill.extend(buckets[s][per:])
            buckets[s] = buckets[s][:per]
    for s in range(n_shards):
        while len(buckets[s]) < per and spill:
            buckets[s].append(spill.pop())
        order.extend(buckets[s])
    return np.asarray(order, dtype=np.int64)


def place_experts(p, perm: np.ndarray) -> ParamTree:
    """The MoE parameters ``p`` with a placement permutation applied to
    the stacked expert weights and the router's columns."""
    out = dict(p.named_parameters())
    idx = torch.as_tensor(perm, device=p.router.device)
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = out[name][idx]
    out["router"] = out["router"][:, idx]
    return ParamTree(out)
