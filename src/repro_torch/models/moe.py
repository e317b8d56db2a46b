"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``; deepseek-v2:
2 shared + 160 routed top-6, llama4-scout: shared + 16 routed top-1).

Sort-based capacity dispatch as in GShard/Switch: (token, choice) pairs
are sorted by expert, scattered into per-expert capacity buffers
(E, cap, d), run through three batched expert matmuls and gathered back;
pairs beyond an expert's capacity are dropped.  The capacity rule, the
stable sort and the top-k are the reference's, so both packages drop
the same tokens.

``moe_ffn_a2a`` is the expert-parallel form over the ``model`` axis of
the current mesh (`models/shardings.py`): each rank holds its block of
experts, and tokens travel to them and back by two all-to-alls.

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

from repro_torch.models import shardings as SH
from repro_torch.models.layers import ParamTree, normal, swiglu, whole

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


def init_moe(gen: torch.Generator, cfg, dtype, keep=whole) -> dict:
    """The reference's draws, in its order; ``keep(name, t)`` is given each
    drawn tensor at once and returns the part to hold (a rank's block)."""
    d = cfg.d_model
    dff = cfg.d_ff_expert or cfg.d_ff
    e = cfg.n_experts
    p = {
        "router": keep("moe.router", normal(gen, (d, e), 0.02, torch.float32)),
        "w_gate": keep("moe.w_gate", normal(gen, (e, d, dff), 0.02, dtype)),
        "w_up": keep("moe.w_up", normal(gen, (e, d, dff), 0.02, dtype)),
        "w_down": keep("moe.w_down", normal(gen, (e, dff, d), 0.02, dtype)),
    }
    if cfg.n_shared_experts:
        sdff = cfg.n_shared_experts * dff
        p.update({
            "ws_gate": keep("moe.ws_gate", normal(gen, (d, sdff), 0.02, dtype)),
            "ws_up": keep("moe.ws_up", normal(gen, (d, sdff), 0.02, dtype)),
            "ws_down": keep("moe.ws_down", normal(gen, (sdff, d), 0.02,
                                                   dtype)),
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


def _route(router, xt: torch.Tensor, cfg, cap: int, tap: bool = True):
    """Dispatch of G groups of T tokens (xt: (G, T, d)) at capacity
    ``cap``: router, top-k (reported to the gate tap when ``tap``), the
    stable sort of the (token, choice) pairs by expert, each pair's slot
    in the (E·cap) buffers.  Returns (keep, slot, rows, pt, pg, buf), buf
    (G, E·cap, d) holding each kept pair's token."""
    g, t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xt.device
    logits = (xt.to(router.dtype) @ router).float()              # (G,T,E)
    gate_vals, gate_idx = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    if tap:
        _emit_gates(gate_idx.reshape(-1, k))
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
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
    return keep, slot, rows, pt, pg, buf


def _experts(p, expert_in: torch.Tensor) -> torch.Tensor:
    """The SwiGLU expert stacks over their buffers (E, rows, d)."""
    h = F.silu(expert_in @ p.w_gate) * (expert_in @ p.w_up)
    return h @ p.w_down


def _combine(xt, out, keep, slot, rows, pt, pg) -> torch.Tensor:
    """Each kept pair's expert output (``out``: (G, E·cap, d)) weighted by
    its gate and summed into its token's row: (G, T, d)."""
    contrib = torch.where(keep[..., None],
                          out[rows, slot] * pg[..., None].to(xt.dtype), 0.0)
    return xt.new_zeros(xt.shape).index_put_((rows, pt), contrib,
                                             accumulate=True)


def _global_rows(x: torch.Tensor, mesh) -> tuple:
    """(the global batch, this rank's block index): ``x``'s rows gathered
    over the data axes of ``mesh``, in row order.  The rank's own block
    is ``x`` itself, so that only it stays on the autograd graph: a
    token's output depends on the other rows only through the capacity
    drops, which have no gradient."""
    i, n = SH.block_index(SH._fs_entry(mesh.axis_names), mesh) \
        if mesh is not None else (0, 1)
    if n == 1:
        return x, 0
    xg = x.detach()
    for a in reversed(SH.fsdp_axes(mesh.axis_names)):
        if mesh.extent(a) > 1:
            xg = mesh.all_gather(xg, a, dim=0)
    b = x.shape[0]
    return torch.cat([xg[:i * b], x, xg[(i + 1) * b:]]), i


def moe_ffn(p, x: torch.Tensor, cfg, per_row: bool = False) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d).

    The B·S tokens dispatch as one group, as in the reference, unless
    ``per_row``: then each batch row is a group of its S tokens with its
    own capacity.  The batched decode asks for that, because the
    reference decodes each slot in its own call.

    Under a mesh (`models/shardings.use_mesh`) ``x`` holds the rank's
    rows of the batch and ``p`` its block of E/M experts and of the
    shared expert; the numbers stay the reference's ``moe_ffn``'s as
    GSPMD runs it.  Without ``per_row`` the dispatch group is the global
    batch, so the rows are gathered over the data axes (`_global_rows`)
    and the rank keeps its own rows of the result; the rank runs its own
    experts' buffers only, and their contributions, with the shared
    expert's partial product, are summed over ``model``."""
    b, s, d = x.shape
    e = cfg.n_experts
    e_loc = p.w_gate.shape[0]
    mesh = SH.current_mesh()
    lo = mesh.axis_index("model") * e_loc if e_loc < e else 0
    xg, i = (x, 0) if per_row else _global_rows(x, mesh)
    g, t = (b, s) if per_row else (1, xg.shape[0] * s)
    xt = xg.reshape(g, t, d)
    cap = capacity(t, cfg)
    keep, slot, rows, pt, pg, buf = _route(p.router, xt, cfg, cap)
    expert_in = buf.reshape(g, e, cap, d)[:, lo:lo + e_loc].transpose(0, 1) \
        .reshape(e_loc, g * cap, d)
    out = _experts(p, expert_in).reshape(e_loc, g, cap, d).transpose(0, 1)
    if e_loc < e:       # the other experts' rows come with the psum
        out = F.pad(out, (0, 0, 0, 0, lo, e - lo - e_loc))
    y = _combine(xt, out.reshape(g, e * cap, d), keep, slot, rows, pt, pg)
    y = y.reshape(-1, s, d)[i * b:(i + 1) * b]
    if cfg.n_shared_experts:
        y = y + swiglu(x, p.ws_gate, p.ws_up, p.ws_down)
    return SH.tp_psum(y)


def moe_ffn_a2a(p, x: torch.Tensor, cfg, per_row: bool = False
                ) -> torch.Tensor:
    """Expert-parallel MoE over the current mesh's ``model`` axis (the
    reference's ``shard_map`` body, per rank).  ``x`` holds the rank's
    rows of the batch (B/D, S, d), whole over the sequence; rank j of the
    ``model`` axis holds experts j·E/M … (j+1)·E/M − 1 (``p.w_*``) and
    column / row blocks of the shared expert.

    With S a multiple of M > 1, each rank takes its S/M slice of the
    sequence (the reference's ``P(batch, "model", None)``), dispatches it
    at the per-(source → expert) capacity max(8, ⌈t_loc·k·cf/E⌉), sends
    each rank its experts' buffers (`Mesh.all_to_all`), runs its experts
    over the M sources' buffers, sends the outputs back, combines, and
    all-gathers the sequence over ``model`` for the next layer.
    Otherwise — no mesh, M = 1, S not a multiple of M (every decode
    step), or ``per_row`` — it is `moe_ffn`, which alone reports to the
    gate tap, as in the reference."""
    mesh = SH.current_mesh()
    m = SH.model_extent(mesh)
    if m == 1 or x.shape[1] % m or per_row:
        return moe_ffn(p, x, cfg, per_row)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc, sl = e // m, s // m
    j = mesh.axis_index("model")
    xs = x[:, j * sl:(j + 1) * sl].reshape(1, b * sl, d)
    # per-(source shard → expert) capacity
    cap = max(8, int(math.ceil(b * sl * k * cfg.capacity_factor / e)))
    keep, slot, rows, pt, pg, buf = _route(p.router, xs, cfg, cap, tap=False)
    # exchange: rank i receives every source's block i
    recv = mesh.all_to_all(buf.reshape(m, e_loc * cap, d), "model")
    expert_in = recv.reshape(m, e_loc, cap, d).transpose(0, 1) \
        .reshape(e_loc, m * cap, d)
    back = _experts(p, expert_in).reshape(e_loc, m, cap, d) \
        .transpose(0, 1).reshape(m, e_loc * cap, d)
    ret = mesh.all_to_all(back, "model")
    y = _combine(xs, ret.reshape(1, e * cap, d), keep, slot, rows, pt, pg)
    y = mesh.all_gather(y.reshape(b, sl, d), "model", dim=1)
    if cfg.n_shared_experts:
        y = y + SH.tp_psum(swiglu(x, p.ws_gate, p.ws_up, p.ws_down))
    return y


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


def _placed_block(w: torch.Tensor, perm: np.ndarray, mesh) -> torch.Tensor:
    """The rank's block of a placed expert stack: slot ``lo + i`` holds
    expert ``perm[lo + i]``, whose weights lie on rank ``perm // E_loc``.
    Each rank's block goes to the others in turn, as a psum of it and
    zeros (a broadcast in SPMD), so the transient memory is one block."""
    e_loc = w.shape[0]
    j = mesh.axis_index("model")
    want = np.asarray(perm)[j * e_loc:(j + 1) * e_loc]
    out = torch.empty_like(w)
    for src in range(mesh.extent("model")):
        buf = w.clone() if src == j else torch.zeros_like(w)
        mesh.psum(buf, "model")
        mine = np.flatnonzero(want // e_loc == src)
        if len(mine):
            out[torch.as_tensor(mine, device=w.device)] = buf[
                torch.as_tensor(want[mine] % e_loc, device=w.device)]
    return out


def place_experts(p, perm: np.ndarray, mesh=None) -> ParamTree:
    """The MoE parameters ``p`` with a placement permutation applied to
    the stacked expert weights and the router's columns.  With a
    ``mesh`` whose ``model`` extent M > 1, ``p`` holds the rank's
    experts, and the rank keeps the experts of its slots of the placed
    stack (`_placed_block`)."""
    out = dict(p.named_parameters())
    idx = torch.as_tensor(perm, device=p.router.device)
    m = SH.model_extent(mesh)
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = (_placed_block(out[name], perm, mesh) if m > 1
                     else out[name][idx])
    out["router"] = out["router"][:, idx]
    return ParamTree(out)
