"""Uncoarsening refinement (paper §2.1).

Three refiners, mirroring KaFFPa's arsenal under the batch-synchronous
adaptation:

  * ``refine_kway``      — round-based k-way gain refinement (the FM variant:
    all boundary nodes eligible, best-gain moves, balance-capped, undo to the
    best feasible cut seen).
  * ``multi_try_refine`` — the *multi-try FM* analogue: search is seeded from
    a random subset of boundary nodes and expands only through moved nodes'
    neighbourhoods (localized search escapes local optima, §2.1).
  * ``flow_refine``      — max-flow min-cut improvement on the boundary band
    of a block pair (host-side Dinic; the ``strong`` preset applies it on
    small/coarse levels, where KaHIP also concentrates its flow budget).

Every k-way entry point routes through `_refine_scan_batch`, one Python
round loop over a leading batch of candidate rows.  Each row draws its
tie-break noise from its own torch.Generator, seeded from that row's seed
alone, so a row's result never depends on the rows batched beside it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.csr import (Graph, CooGraph, EllGraph, resolve_device,
                                  to_coo, to_ell)
from repro_torch.core.partition import edge_cut_device, edge_cut, is_feasible
from repro_torch.core import lp as lp_mod


def default_use_kernel(device) -> bool:
    """Resolve ``use_kernel=None``: the CUDA affinity kernel is the default
    k-way refinement path on a CUDA device; on the CPU the COO scatter
    path runs instead."""
    return torch.device(device).type == "cuda"


# ---------------------------------------------------------------------------
# batched k-way gain refinement
# ---------------------------------------------------------------------------

def _round_noise(noise: lp_mod.Noise, r: int, n: int, k: int,
                 device) -> torch.Tensor:
    """Round ``r``'s (B, n, k) draws: a slice of a (B, R, n, k) tensor, or
    one fresh draw from each row's generator."""
    if isinstance(noise, torch.Tensor):
        return noise[:, r]
    return torch.stack([lp_mod.uniform_noise(gen, (n, k), device)
                        for gen in noise])


def _refine_scan_batch(g: CooGraph, labels0: torch.Tensor, cap: torch.Tensor,
                       noise: lp_mod.Noise, nrounds: torch.Tensor,
                       zero_gain: torch.Tensor, force: torch.Tensor,
                       active0: torch.Tensor, k: int, rounds: int,
                       ell: Optional[EllGraph] = None):
    """THE k-way refinement program: everything routes through here.

    ``labels0`` (B, n_pad) int32 candidates; ``cap`` (k,); ``noise`` the
    per-round draws, a (B, rounds, n_pad, k) tensor or B generators;
    ``nrounds`` (B,) masks a row's trailing rounds to no-ops; ``zero_gain``
    and ``force`` (B,) bools; ``active0`` (B, n_pad) bools seed the
    localized search (all-ones = unrestricted).  With an ``ell`` view the
    affinities come from ``kernels/ops.lp_affinity`` (the CUDA kernel on a
    card), without one from the COO scatter.  Returns (labels (B, n_pad),
    cut (B,)).  Rounds past every row's ``nrounds`` are no-ops for
    all rows and are not run.
    """
    n = g.n_pad
    b = labels0.shape[0]
    vw = g.vwgt
    dev = g.device
    sizes0 = torch.zeros(b, k, dtype=torch.float32, device=dev).scatter_add_(
        1, labels0.long(), vw.expand(b, -1))
    cut0 = edge_cut_device(g, labels0)
    feas0 = (sizes0 - cap).amax(1) <= 1e-6
    best_cut = torch.where(feas0, cut0, torch.inf)
    affinity_fn = None
    if ell is not None:
        from repro_torch.kernels import ops as kops
        affinity_fn = lambda _g, lab, kk: kops.lp_affinity(   # noqa: E731
            ell.nbr, ell.wgt, lab, kk)
    live_edge = g.w > 0
    labels, sizes, active, best_labels = labels0, sizes0, active0, labels0
    for parity in range(min(rounds, int(nrounds.max()))):
        nz = _round_noise(noise, parity, n, k, dev)
        prop_labels, prop_sizes = lp_mod.kway_lp_round(
            g, labels, sizes, cap, nz, k, parity, active, zero_gain, force,
            affinity_fn=affinity_fn)
        live = (parity < nrounds)[:, None]
        new_labels = torch.where(live, prop_labels, labels)
        new_sizes = torch.where(live, prop_sizes, sizes)
        moved = new_labels != labels
        hits = (moved[:, g.src_long] & live_edge).to(torch.int32)
        reach = torch.zeros(b, n, dtype=torch.int32, device=dev).scatter_add_(
            1, g.dst_long.expand(b, -1), hits) > 0
        active = active | reach | moved
        cut = edge_cut_device(g, new_labels)
        feas = (new_sizes - cap).amax(1) <= 1e-6
        better = feas & (cut < best_cut)
        best_cut = torch.where(better, cut, best_cut)
        best_labels = torch.where(better[:, None], new_labels, best_labels)
        labels, sizes = new_labels, new_sizes
    # undo-to-best (KaFFPa semantics): return best feasible if one was seen
    have_best = torch.isfinite(best_cut)
    out = torch.where(have_best[:, None], best_labels, labels)
    return out, torch.where(have_best, best_cut, edge_cut_device(g, labels))


def _caps_for(g: Graph, k: int, eps: float,
              fractions: Optional[np.ndarray] = None) -> np.ndarray:
    total = g.total_vwgt()
    if fractions is None:
        lmax = np.ceil(total / k)
        return np.full(k, (1.0 + eps) * lmax)
    return (1.0 + eps) * np.asarray(fractions) * total


def row_seed(seed: int, row: int) -> int:
    """The generator seed of batch row ``row`` of a call seeded ``seed``:
    a function of the two alone, never of the batch size."""
    ss = np.random.SeedSequence(seed % (1 << 63), spawn_key=(row,))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _generators(seeds: Sequence[int], device) -> list:
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def _run_scan_batch(coo, cap_np, labs, seeds, nrounds, zero, force, active,
                    k, rounds, ell):
    """Shared batched-entry plumbing: host arrays in, host int64 rows out."""
    dev = coo.device

    def put(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype=dtype)).to(dev)

    outs, _ = _refine_scan_batch(
        coo, put(labs, np.int32), put(cap_np, np.float32),
        _generators(seeds, dev), put(nrounds, np.int64), put(zero, bool),
        put(force, bool), put(active, bool), k, rounds, ell=ell)
    return outs.cpu().numpy().astype(np.int64)


def _views(g: Graph, coo, ell, use_kernel, device):
    """Resolve (coo, ell) for a host-level entry: cached views fix the
    device, else ``device`` does (None = CUDA).  ``ell`` is None exactly
    when the scan is to take the COO path."""
    dev = coo.device if coo is not None else resolve_device(device)
    use_kernel = default_use_kernel(dev) if use_kernel is None else use_kernel
    coo = coo if coo is not None else to_coo(g, device=dev)
    if not use_kernel:
        return coo, None
    # same n_pad as the COO view
    return coo, (ell if ell is not None
                 else to_ell(g, row_tile=coo.n_pad, device=dev))


def refine_kway(g: Graph, part: np.ndarray, k: int, eps: float = 0.03,
                rounds: int = 12, seed: int = 0,
                fractions: Optional[np.ndarray] = None,
                coo: Optional[CooGraph] = None,
                force_balance: bool = False,
                use_kernel: Optional[bool] = None,
                ell: Optional[EllGraph] = None,
                device=None) -> np.ndarray:
    """Polish ``part``; never returns a worse feasible cut (undo-to-best).

    ``use_kernel=None`` resolves to the device default (the CUDA kernel on
    a card, the COO scatter on the CPU); ``coo``/``ell`` accept cached
    per-level views, which also fix the device.
    """
    if k <= 1 or g.n == 0:
        return part
    coo, ell = _views(g, coo, ell, use_kernel, device)
    labs = np.zeros((1, coo.n_pad), dtype=np.int32)
    labs[0, :g.n] = part
    outs = _run_scan_batch(coo, _caps_for(g, k, eps, fractions), labs,
                           [row_seed(seed, 0)], [rounds], [False],
                           [force_balance], np.ones((1, coo.n_pad), bool),
                           k, rounds, ell)
    out = outs[0][:g.n]
    # paranoia: keep the better of (in, out) among feasible options
    if edge_cut(g, out) <= edge_cut(g, part) or force_balance:
        return out
    return part


def refine_kway_batch(g: Graph, parts: list, k: int, eps: float = 0.03,
                      rounds: int = 12, seed: int = 0,
                      coo: Optional[CooGraph] = None,
                      ell: Optional[EllGraph] = None,
                      use_kernel: Optional[bool] = None,
                      seeds: Optional[Sequence[int]] = None,
                      device=None) -> list:
    """Refine several candidate partitions in one batched device call.

    The initial-partition tournament uses this; per-candidate force-balance
    rides along as a per-row flag.  ``seeds`` overrides the per-candidate
    generator seeds (default ``row_seed(seed, i)`` for row i).
    """
    if k <= 1 or g.n == 0 or not parts:
        return [np.asarray(p, dtype=np.int64) for p in parts]
    coo, ell = _views(g, coo, ell, use_kernel, device)
    labs = np.zeros((len(parts), coo.n_pad), dtype=np.int32)
    for i, p in enumerate(parts):
        labs[i, :g.n] = p
    force = np.asarray([not is_feasible(g, p, k, eps) for p in parts])
    if seeds is None:
        seeds = [row_seed(seed, i) for i in range(len(parts))]
    outs = _run_scan_batch(coo, _caps_for(g, k, eps), labs, seeds,
                           np.full(len(parts), rounds),
                           np.zeros(len(parts), bool), force,
                           np.ones((len(parts), coo.n_pad), bool),
                           k, rounds, ell)
    outs = outs[:, :g.n]
    result = []
    for i, p in enumerate(parts):
        # same per-candidate paranoia as refine_kway
        if edge_cut(g, outs[i]) <= edge_cut(g, p) or force[i]:
            result.append(outs[i])
        else:
            result.append(np.asarray(p, dtype=np.int64))
    return result


def multi_try_refine(g: Graph, part: np.ndarray, k: int, eps: float = 0.03,
                     tries: int = 3, rounds: int = 8, seed: int = 0,
                     seed_frac: float = 0.05,
                     coo: Optional[CooGraph] = None,
                     device=None) -> np.ndarray:
    """Multi-try FM analogue: several localized searches from random boundary
    seeds; keeps the best feasible result.  Like the JAX package's, these
    searches run the COO path."""
    if k <= 1 or g.n == 0:
        return part
    coo, _ = _views(g, coo, None, False, device)
    cap_np = _caps_for(g, k, eps)
    best = np.asarray(part, dtype=np.int64)
    best_cut = edge_cut(g, best)
    rng = np.random.default_rng(seed)
    src = g.edge_sources()
    for t in range(tries):
        labs = np.zeros((1, coo.n_pad), dtype=np.int32)
        labs[0, :g.n] = best
        bnd = np.unique(src[best[src] != best[g.adjncy]])
        if len(bnd) == 0:
            break
        nseed = max(1, int(len(bnd) * seed_frac))
        chosen = rng.choice(bnd, size=nseed, replace=False)
        active0 = np.zeros((1, coo.n_pad), dtype=bool)
        active0[0, chosen] = True
        outs = _run_scan_batch(coo, cap_np, labs,
                               [row_seed(seed * 997 + t, 0)], [rounds],
                               [True], [False], active0, k, rounds, None)
        out = outs[0][:g.n]
        c = edge_cut(g, out)
        if c < best_cut:
            best, best_cut = out, c
    return best


# ---------------------------------------------------------------------------
# flow-based refinement (host, 2 blocks, boundary band)
# ---------------------------------------------------------------------------

def _dinic(nv: int, edges: list, s: int, t: int):
    """Dinic max-flow. edges: list of [u, v, cap]; returns (flow, S-side set)."""
    graph = [[] for _ in range(nv)]
    for (u, v, c) in edges:
        graph[u].append([v, c, len(graph[v])])
        graph[v].append([u, 0, len(graph[u]) - 1])

    def bfs():
        level = [-1] * nv
        level[s] = 0
        q = [s]
        for u in q:
            for e in graph[u]:
                if e[1] > 0 and level[e[0]] < 0:
                    level[e[0]] = level[u] + 1
                    q.append(e[0])
        return level if level[t] >= 0 else None

    def dfs(u, f, level, it):
        if u == t:
            return f
        while it[u] < len(graph[u]):
            e = graph[u][it[u]]
            if e[1] > 0 and level[e[0]] == level[u] + 1:
                d = dfs(e[0], min(f, e[1]), level, it)
                if d > 0:
                    e[1] -= d
                    graph[e[0]][e[2]][1] += d
                    return d
            it[u] += 1
        return 0

    flow = 0
    while True:
        level = bfs()
        if level is None:
            break
        it = [0] * nv
        while True:
            f = dfs(s, float("inf"), level, it)
            if f == 0:
                break
            flow += f
    # S side of the min cut = reachable in residual
    seen = [False] * nv
    seen[s] = True
    q = [s]
    for u in q:
        for e in graph[u]:
            if e[1] > 0 and not seen[e[0]]:
                seen[e[0]] = True
                q.append(e[0])
    return flow, np.asarray(seen)


def flow_refine_pair(g: Graph, part: np.ndarray, a: int, b: int,
                     eps: float, band_depth: int = 2,
                     max_band: int = 4000) -> np.ndarray:
    """Max-flow min-cut improvement between blocks a and b (paper §2.1).

    Grows a band around the a|b boundary sized so that *any* s-t cut inside
    it keeps both blocks within the balance constraint, then replaces the
    boundary with the min cut.
    """
    part = np.asarray(part, dtype=np.int64)
    k = int(part.max()) + 1
    total = g.total_vwgt()
    lmax = (1.0 + eps) * np.ceil(total / k)
    in_pair = (part == a) | (part == b)
    src = g.edge_sources()
    # boundary nodes of the pair
    bmask = np.zeros(g.n, dtype=bool)
    cutedges = in_pair[src] & in_pair[g.adjncy] & (part[src] != part[g.adjncy])
    bmask[src[cutedges]] = True
    if not bmask.any():
        return part
    wa = int(g.vwgt[part == a].sum())
    wb = int(g.vwgt[part == b].sum())
    # budget: how much weight may cross either way
    slack_a = lmax - wa      # room in a
    slack_b = lmax - wb
    band = bmask.copy()
    # BFS out `band_depth` steps inside each block, capped by slack so every
    # cut in the band is feasible (moving whole band-side stays within lmax)
    for side, slack in ((a, slack_b), (b, slack_a)):
        depth_mask = bmask & (part == side)
        wsum = int(g.vwgt[depth_mask].sum())
        cur = depth_mask
        for _ in range(band_depth):
            nxt = np.zeros(g.n, dtype=bool)
            hits = cur[src] & (part[g.adjncy] == side) & ~band[g.adjncy] & ~cur[g.adjncy]
            nxt[g.adjncy[hits]] = True
            add_ids = np.flatnonzero(nxt)
            order = np.argsort(g.vwgt[add_ids])  # cheap nodes first
            for i in add_ids[order]:
                if wsum + int(g.vwgt[i]) > slack or band.sum() > max_band:
                    break
                band[i] = True
                wsum += int(g.vwgt[i])
            cur = nxt & band
            if not cur.any():
                break
    ids = np.flatnonzero(band)
    if len(ids) > max_band:
        return part
    remap = -np.ones(g.n, dtype=np.int64)
    remap[ids] = np.arange(len(ids))
    nv = len(ids) + 2
    S, T = len(ids), len(ids) + 1
    edges = []
    inside = band[src] & band[g.adjncy]
    fwd = inside & (src < g.adjncy)
    for e in np.flatnonzero(fwd):
        u, v, w = remap[src[e]], remap[g.adjncy[e]], int(g.adjwgt[e])
        edges.append([u, v, w])
        edges.append([v, u, w])
    big = int(g.adjwgt.sum()) + 1
    # attach S to band nodes adjacent to non-band a-side, T to b-side
    touch_a = band[src] & ~band[g.adjncy] & (part[g.adjncy] == a)
    touch_b = band[src] & ~band[g.adjncy] & (part[g.adjncy] == b)
    for u in np.unique(src[touch_a]):
        edges.append([S, remap[u], big])
    for u in np.unique(src[touch_b]):
        edges.append([remap[u], T, big])
    flow, sside = _dinic(nv, edges, S, T)
    new_part = part.copy()
    new_part[ids] = np.where(sside[:len(ids)], a, b)
    # accept only if feasible and not worse
    bw = np.zeros(k, dtype=np.int64)
    np.add.at(bw, new_part, g.vwgt)
    if bw.max() > lmax + 1e-9:
        return part
    if edge_cut(g, new_part) <= edge_cut(g, part):
        return new_part
    return part


def flow_refine_all_pairs(g: Graph, part: np.ndarray, k: int, eps: float,
                          max_n: int = 20000, seed: int = 0) -> np.ndarray:
    """Apply pairwise flow refinement over all adjacent block pairs."""
    if g.n > max_n:
        return part
    part = np.asarray(part, dtype=np.int64)
    src = g.edge_sources()
    for a in range(k):
        for b in range(a + 1, k):
            touching = np.any((part[src] == a) & (part[g.adjncy] == b))
            if touching:
                part = flow_refine_pair(g, part, a, b, eps)
    return part
