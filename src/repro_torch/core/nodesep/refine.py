"""Size-constrained separator refinement — device side.

The 3-label state {A=0, B=1, S=2} is refined with the batch-synchronous LP
adaptation of FM for node separators: per round every separator vertex
computes its *pull-in cost* for leaving S into one side, a conflict-free
subset of moves is applied under the block-size caps, and the opposite-side
neighbours of every mover are pulled into S (the two-hop mask that keeps
the invariant "no A vertex adjacent to a B vertex" by construction).

The gain of moving v from S into block ``s`` is

    gain(v → s) = w(v) − Σ { w(u) : u ∈ N(v), label(u) = other(s) }

i.e. the separator sheds w(v) and absorbs the opposite-side neighbours.
The per-neighbour *vertex-weight* histogram aff[v, b] = Σ_{u∈N(v)} w(u)·
[label(u)=b] is the lp_affinity contraction with k=3 and the edge weights
replaced by gathered neighbour vertex weights: ``kernels/ops.sep_affinity``
(the CUDA kernel on a card) on the ELL view, the COO scatter here
otherwise — bit for bit the same, as the sums are integers in f32.

Rounds alternate the target side (A on even parity, B on odd): with all
moves of a round going to one side, a mover can never become adjacent to
the opposite block — its opposite-side neighbours are pulled into S in the
same update.  Summed single-move gains are conservative (a pulled vertex
shared by two movers is counted twice but enters S once), and undo-to-best
over feasible states guards the objective like every other refiner here.

Tie-break noise comes in as an argument, as in core/refine.py: a
(B, rounds, n_pad) tensor of draws, or one torch.Generator per row seeded
by ``refine.row_seed``, so a row's result never depends on its batch.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import lp as lp_mod
from repro_torch.core import refine as R
from repro_torch.core.csr import (CooGraph, EllGraph, Graph, resolve_device,
                                  to_coo)
from repro_torch.core.lp import _GAIN_EPS, _NEG

SEP = 2                 # the separator label


# ---------------------------------------------------------------------------
# neighbour vertex-weight affinity: COO scatter and the kernel path
# ---------------------------------------------------------------------------

def _coo_affinity(src, dst, w, vw, labels: torch.Tensor) -> torch.Tensor:
    """(B, n_pad, 3) histogram over graph tensors with a leading dim of 1
    (one graph for every row) or B (row i on graph i): ``src``/``dst``
    int64 and ``w`` f32 (G, e_pad), ``vw`` f32 (G, n_pad)."""
    b = labels.shape[0]
    contrib = torch.where(w > 0, vw.gather(1, dst), 0.0)
    idx = src * 3 + labels.gather(1, dst.expand(b, -1)).long()
    aff = torch.zeros(b, labels.shape[1] * 3, dtype=torch.float32,
                      device=labels.device)
    aff.scatter_add_(1, idx, contrib.expand(b, -1))
    return aff.view(b, -1, 3)


def sep_affinity_coo(g: CooGraph, labels: torch.Tensor) -> torch.Tensor:
    """aff[b, v, c] = total *vertex weight* of v's neighbours with label c
    in row b of ``labels`` (B, n_pad) → (B, n_pad, 3).

    Padding edges carry w == 0 and are masked out explicitly: when
    n == n_pad the sentinel row is a real vertex with nonzero weight.
    """
    return _coo_affinity(g.src_long[None], g.dst_long[None], g.w[None],
                         g.vwgt[None], labels)


def sep_affinity_ell(ell: EllGraph, labels: torch.Tensor,
                     vw_nbr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel path: ``ops.sep_affinity`` on the ELL view (the CUDA kernel
    on a card, its plain version on the CPU); ``vw_nbr`` is the view's
    cached ``ops.sep_weights``."""
    from repro_torch.kernels import ops as kops
    return kops.sep_affinity(ell.nbr, ell.wgt, ell.vwgt, labels,
                             vw_nbr=vw_nbr)


# ---------------------------------------------------------------------------
# the separator LP/FM scan
# ---------------------------------------------------------------------------

def _round_noise(noise: lp_mod.Noise, r: int, n: int,
                 device) -> torch.Tensor:
    """Round ``r``'s (B, n) draws: a slice of a (B, R, n) tensor, or one
    fresh draw from each row's generator."""
    if isinstance(noise, torch.Tensor):
        return noise[:, r]
    return torch.stack([lp_mod.uniform_noise(gen, (n,), device)
                        for gen in noise])


def _sep_refine_scan(src, dst, w, vw, labels0: torch.Tensor,
                     cap: torch.Tensor, noise: lp_mod.Noise,
                     force: torch.Tensor, rounds: int, affinity):
    """``rounds`` one-side-per-round separator moves with undo-to-best,
    for B candidate rows at once.

    Graph tensors as in `_coo_affinity` (leading dim 1 or B); ``labels0``
    (B, n_pad) int32; ``cap`` (B, 2), the block-size caps of A and B per
    row (S is uncapped: its weight *is* the objective); ``force`` (B,)
    bools: an overweight block pushes boundary vertices into S, capped at
    the overshoot so balance restoration inflates S minimally.
    ``affinity(labels)`` gives the (B, n_pad, 3) histogram.
    """
    b, n = labels0.shape
    dev = labels0.device
    live = w > 0
    vw_max = vw.amax(1)
    node_ids = torch.arange(n, device=dev)
    gain_eps = torch.tensor(_GAIN_EPS, dtype=torch.float32, device=dev)

    def sizes_of(lab):
        return torch.zeros(b, 3, dtype=torch.float32, device=dev).scatter_add_(
            1, lab.long(), vw.expand(b, -1))

    def feasible(sz):
        return (sz[:, 0] <= cap[:, 0] + 1e-6) & (sz[:, 1] <= cap[:, 1] + 1e-6)

    labels = best_labels = labels0
    sizes = sizes_of(labels0)
    best_w = torch.where(feasible(sizes), sizes[:, SEP], torch.inf)
    for parity in range(rounds):
        side, other = parity % 2, 1 - parity % 2     # this round's target
        aff = affinity(labels)
        nz = _round_noise(noise, parity, n, dev)
        in_sep = labels == SEP
        # gain of leaving S into `side`: shed w(v), absorb other-side nbrs
        gain = vw - aff[..., other] + nz
        # plateau rounds (every third) admit zero-gain moves: the separator
        # slides sideways to thinner regions; undo-to-best keeps it safe
        thresh = -gain_eps if parity % 3 == 2 else gain_eps
        want_move = in_sep & (gain > thresh)
        # forced balance: the most-overweight block pushes into S
        over0 = sizes[:, 0] - cap[:, 0]
        over1 = sizes[:, 1] - cap[:, 1]
        over_blk = torch.where(over0 >= over1, 0, 1).to(labels.dtype)
        overshoot = torch.maximum(over0, over1).clamp_min(0.0)
        forced = force & (overshoot > 0)
        want_push = (forced[:, None] & (labels == over_blk[:, None])
                     & (vw > 0))
        # parity mask (avoid neighbouring-move oscillation)
        node_par = (node_ids + parity) % 2 == 0
        want_move = want_move & node_par
        want_push = want_push & node_par
        proposal = torch.where(want_move, side, labels)
        proposal = torch.where(want_push, SEP, proposal)
        # pushes prefer boundary vertices (adjacent to S or the other side)
        pri = torch.where(want_move, gain, _NEG)
        pri = torch.where(want_push, aff[..., SEP] + aff[..., other] + nz,
                          pri)
        # S admits at most the overshoot (padded by one vertex so integer
        # weights can actually cross it), so forced pushes stop at balance
        push_room = torch.where(overshoot > 0, overshoot + vw_max, 0.0)
        cap3 = torch.stack([cap[:, 0], cap[:, 1], sizes[:, SEP] + push_room],
                           1)
        new_labels = lp_mod.capped_accept(labels, proposal, vw, sizes, cap3,
                                          pri)
        # two-hop pull-in: opposite-side neighbours of movers enter S
        moved = (new_labels != labels) & in_sep
        hits = (moved.gather(1, src.expand(b, -1)) & live).to(torch.int32)
        reach = torch.zeros(b, n, dtype=torch.int32, device=dev).scatter_add_(
            1, dst.expand(b, -1), hits) > 0
        new_labels = torch.where(reach & (labels == other), SEP, new_labels)
        new_sizes = sizes_of(new_labels)
        better = feasible(new_sizes) & (new_sizes[:, SEP] < best_w)
        best_w = torch.where(better, new_sizes[:, SEP], best_w)
        best_labels = torch.where(better[:, None], new_labels, best_labels)
        labels, sizes = new_labels, new_sizes
    have_best = torch.isfinite(best_w)
    out = torch.where(have_best[:, None], best_labels, labels)
    return out, torch.where(have_best, best_w, sizes[:, SEP])


def _sep_refine_scan_batch(g: CooGraph, labels0: torch.Tensor,
                           cap: torch.Tensor, noise: lp_mod.Noise,
                           force: torch.Tensor, rounds: int,
                           ell: Optional[EllGraph] = None,
                           vw_nbr: Optional[torch.Tensor] = None):
    """THE separator refinement program: one graph, B candidate rows.

    ``labels0`` (B, n_pad) int32; ``cap`` (2,); ``noise`` the per-round
    draws, a (B, rounds, n_pad) tensor or B generators; ``force`` (B,)
    bools.  With an ``ell`` view the affinities come from
    ``ops.sep_affinity`` over ``vw_nbr`` (built here once when the caller
    holds none), without one from the COO scatter (``vw_nbr`` unused).
    Returns (labels (B, n_pad), separator weight (B,)).
    """
    if ell is not None:
        if vw_nbr is None:
            from repro_torch.kernels import ops as kops
            vw_nbr = kops.sep_weights(ell.nbr, ell.wgt, ell.vwgt)
        affinity = lambda lab: sep_affinity_ell(ell, lab, vw_nbr)  # noqa: E731
    else:
        affinity = lambda lab: sep_affinity_coo(g, lab)           # noqa: E731
    b = labels0.shape[0]
    return _sep_refine_scan(g.src_long[None], g.dst_long[None], g.w[None],
                            g.vwgt[None], labels0, cap.expand(b, -1), noise,
                            force, rounds, affinity)


def _sep_refine_scan_multi(gs: Sequence[CooGraph], labels0: torch.Tensor,
                           caps: torch.Tensor, noise: lp_mod.Noise,
                           force: torch.Tensor, rounds: int):
    """The scan over *stacked sibling graphs* of one shape bucket: row i
    refines candidate i on graph ``gs[i]`` under caps ``caps[i]`` (B, 2).

    It takes the COO scatter, as the reference's stacked program does by
    design: one ELL kernel launch reads one graph, and these rows hold
    different graphs.  A row's result equals `_sep_refine_scan_batch`'s on
    its own graph with the same draws."""
    src, dst, w, vw = (torch.stack([getattr(g, f) for g in gs])
                       for f in ("src_long", "dst_long", "w", "vwgt"))
    return _sep_refine_scan(src, dst, w, vw, labels0, caps, noise, force,
                            rounds,
                            lambda lab: _coo_affinity(src, dst, w, vw, lab))


# ---------------------------------------------------------------------------
# host wrappers + metrics
# ---------------------------------------------------------------------------

def separator_caps(g: Graph, eps: float) -> np.ndarray:
    """Block caps: max(w(A), w(B)) ≤ (1+eps)·⌈w(V)/2⌉ (§2.8 constraint)."""
    lmax = np.ceil(g.total_vwgt() / 2.0)
    return np.full(2, (1.0 + eps) * lmax)


def separator_weight(g: Graph, labels: np.ndarray) -> int:
    return int(g.vwgt[np.asarray(labels) == SEP].sum())


def separator_is_feasible(g: Graph, labels: np.ndarray, eps: float) -> bool:
    labels = np.asarray(labels)
    cap = separator_caps(g, eps)
    wa = int(g.vwgt[labels == 0].sum())
    wb = int(g.vwgt[labels == 1].sum())
    return wa <= cap[0] + 1e-9 and wb <= cap[1] + 1e-9


def separator_invariant_ok(g: Graph, labels: np.ndarray) -> bool:
    """The structural invariant: no A vertex is adjacent to a B vertex."""
    labels = np.asarray(labels)
    src = g.edge_sources()
    a, b = labels[src], labels[g.adjncy]
    return not np.any(((a == 0) & (b == 1)) | ((a == 1) & (b == 0)))


def _put(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=dtype)).to(dev)


def _run_sep_scan_batch(coo, cap_np, labs, seeds, force, rounds, ell,
                        vw_nbr) -> np.ndarray:
    """Shared batched-entry plumbing: host arrays in, host int64 rows out."""
    dev = coo.device
    outs, _ = _sep_refine_scan_batch(
        coo, _put(labs, np.int32, dev), _put(cap_np, np.float32, dev),
        R._generators(seeds, dev), _put(force, bool, dev), rounds, ell=ell,
        vw_nbr=vw_nbr)
    return outs.cpu().numpy().astype(np.int64)


def _pad_labels(cands, n: int, n_pad: int) -> np.ndarray:
    labs = np.zeros((len(cands), n_pad), dtype=np.int32)
    for i, c in enumerate(cands):
        labs[i, :n] = c
    return labs


def refine_separator(g: Graph, labels: np.ndarray, eps: float = 0.20,
                     rounds: int = 10, seed: int = 0,
                     coo: Optional[CooGraph] = None,
                     ell: Optional[EllGraph] = None,
                     vw_nbr: Optional[torch.Tensor] = None,
                     use_kernel: Optional[bool] = None,
                     force_balance: bool = False,
                     device=None) -> np.ndarray:
    """Polish a 3-label state; never worsens a feasible separator weight.

    ``use_kernel=None`` resolves to the device default (the CUDA kernel on
    a card, the COO scatter on the CPU); ``coo``/``ell``/``vw_nbr`` accept
    a level's cached views, which also fix the device (None = CUDA)."""
    if g.n == 0:
        return np.asarray(labels, dtype=np.int64)
    coo, ell = R._views(g, coo, ell, use_kernel, device)
    outs = _run_sep_scan_batch(coo, separator_caps(g, eps),
                               _pad_labels([labels], g.n, coo.n_pad),
                               [R.row_seed(seed, 0)], [force_balance],
                               rounds, ell, vw_nbr)
    out = outs[0][:g.n]
    # paranoia: keep the better of (in, out) among feasible options
    if force_balance:
        return out
    if (separator_weight(g, out) <= separator_weight(g, labels)
            or not separator_is_feasible(g, labels, eps)):
        return out
    return np.asarray(labels, dtype=np.int64)


def refine_separator_batch(g: Graph, cands: List[np.ndarray],
                           eps: float = 0.20, rounds: int = 10, seed: int = 0,
                           coo: Optional[CooGraph] = None,
                           ell: Optional[EllGraph] = None,
                           vw_nbr: Optional[torch.Tensor] = None,
                           use_kernel: Optional[bool] = None,
                           seeds: Optional[Sequence[int]] = None,
                           device=None) -> List[np.ndarray]:
    """Refine several 3-label candidates in one batched device call; row i
    draws from ``seeds[i]``, by default ``row_seed(seed, i)``."""
    if g.n == 0 or not cands:
        return [np.asarray(c, dtype=np.int64) for c in cands]
    coo, ell = R._views(g, coo, ell, use_kernel, device)
    force = np.asarray([not separator_is_feasible(g, c, eps) for c in cands])
    if seeds is None:
        seeds = [R.row_seed(seed, i) for i in range(len(cands))]
    outs = _run_sep_scan_batch(coo, separator_caps(g, eps),
                               _pad_labels(cands, g.n, coo.n_pad), seeds,
                               force, rounds, ell, vw_nbr)
    outs = outs[:, :g.n]
    result = []
    for i, c in enumerate(cands):
        if (separator_weight(g, outs[i]) <= separator_weight(g, c)
                or force[i]):
            result.append(outs[i])
        else:
            result.append(np.asarray(c, dtype=np.int64))
    return result


def refine_separator_multi(graphs: List[Graph],
                           cands_lists: List[List[np.ndarray]],
                           eps: float = 0.20, rounds: int = 10,
                           seeds: Optional[List[int]] = None,
                           coos: Optional[List[CooGraph]] = None,
                           device=None) -> List[List[np.ndarray]]:
    """Refine the candidate tournaments of several *sibling graphs sharing
    one shape bucket* in a single batched device call (COO path).

    Per graph this is bit-identical to ``refine_separator_batch(graphs[i],
    cands_lists[i], seed=seeds[i])`` — rows carry that graph's generators
    ``row_seed(seeds[i], j)``, caps and arrays, so batching changes only
    how many launches run them.
    """
    if not graphs:
        return []
    seeds = seeds if seeds is not None else [0] * len(graphs)
    dev = coos[0].device if coos is not None else resolve_device(device)
    coos = coos if coos is not None else [to_coo(g, device=dev)
                                          for g in graphs]
    n_pad, e_pad = coos[0].n_pad, coos[0].e_pad
    if any(c.n_pad != n_pad or c.e_pad != e_pad for c in coos):
        raise ValueError("refine_separator_multi requires one shape bucket")
    rows_g, rows_lab, rows_cap, rows_seed, rows_force, owner = \
        [], [], [], [], [], []
    for i, (g, cands) in enumerate(zip(graphs, cands_lists)):
        cap = separator_caps(g, eps)
        for j, c in enumerate(cands):
            rows_g.append(coos[i])
            rows_lab.append(c)
            rows_cap.append(cap)
            rows_seed.append(R.row_seed(seeds[i], j))
            rows_force.append(not separator_is_feasible(g, c, eps))
            owner.append((i, j))
    if not rows_g:
        return [[] for _ in graphs]
    labs = np.zeros((len(rows_g), n_pad), dtype=np.int32)
    for r, ((i, _), c) in enumerate(zip(owner, rows_lab)):
        labs[r, :graphs[i].n] = c
    outs, _ = _sep_refine_scan_multi(
        rows_g, _put(labs, np.int32, dev), _put(rows_cap, np.float32, dev),
        R._generators(rows_seed, dev), _put(rows_force, bool, dev), rounds)
    outs = outs.cpu().numpy().astype(np.int64)
    result: List[List[np.ndarray]] = [[] for _ in graphs]
    for row, (i, j) in enumerate(owner):
        g, c = graphs[i], cands_lists[i][j]
        out = outs[row][:g.n]
        # same per-candidate paranoia as refine_separator_batch
        if (separator_weight(g, out) <= separator_weight(g, c)
                or not separator_is_feasible(g, c, eps)):
            result[i].append(out)
        else:
            result[i].append(np.asarray(c, dtype=np.int64))
    return result


# ---------------------------------------------------------------------------
# boundary → separator conversion and the vertex-cover polish (host)
# ---------------------------------------------------------------------------

def boundary_to_separator(g: Graph, part2: np.ndarray) -> np.ndarray:
    """Lift a bipartition to a 3-label state: the lighter boundary side
    becomes S (the paper's trivial separator, §2.8) — invariant holds by
    construction because non-boundary vertices have no cross-block edge."""
    part2 = np.asarray(part2, dtype=np.int64)
    labels = part2.copy()
    src = g.edge_sources()
    cut = part2[src] != part2[g.adjncy]
    b0 = np.unique(src[cut & (part2[src] == 0)])
    b1 = np.unique(src[cut & (part2[src] == 1)])
    w0 = int(g.vwgt[b0].sum())
    w1 = int(g.vwgt[b1].sum())
    labels[b0 if w0 <= w1 else b1] = SEP
    return labels


def flow_separator_polish(g: Graph, labels: np.ndarray, eps: float,
                          band_depth: int = 3,
                          max_band: int = 4000) -> np.ndarray:
    """Optimal separator within a band around S via node-capacitated max-flow
    (the §2.8 'advanced flow-based separator' idea that superseded the
    post-hoc construction).

    Every band vertex v is split into v_in → v_out with capacity w(v); band
    edges get infinite capacity, the source feeds band vertices adjacent to
    the retained A region and the sink drains those adjacent to retained B.
    The min s-t cut is then a *minimum-weight vertex set* separating A from
    B inside the band — the invariant holds structurally for the recut
    labels (an A'–B' adjacency would cross an uncut infinite edge).  Band
    growth into a side is capped by the opposite block's slack so any recut
    stays feasible; the result is adopted only if strictly lighter.
    """
    labels = np.asarray(labels, dtype=np.int64)
    in_sep = labels == SEP
    if not in_sep.any() or int(in_sep.sum()) > max_band:
        return labels
    src = g.edge_sources()
    cap_blk = separator_caps(g, eps)
    w_blk = [int(g.vwgt[labels == 0].sum()), int(g.vwgt[labels == 1].sum())]
    w_sep = int(g.vwgt[in_sep].sum())
    band = in_sep.copy()
    # BFS band_depth steps into each side, budgeted by the other side's slack
    for side in (0, 1):
        budget = cap_blk[1 - side] - w_blk[1 - side] - w_sep
        cur = band.copy()
        wsum = 0
        for _ in range(band_depth):
            nxt = np.zeros(g.n, dtype=bool)
            hits = cur[src] & (labels[g.adjncy] == side) & ~band[g.adjncy]
            nxt[g.adjncy[hits]] = True
            add_ids = np.flatnonzero(nxt)
            order = np.argsort(g.vwgt[add_ids])          # cheap nodes first
            for i in add_ids[order]:
                if wsum + int(g.vwgt[i]) > budget or band.sum() >= max_band:
                    break
                band[i] = True
                wsum += int(g.vwgt[i])
            cur = nxt & band
            if not cur.any():
                break
    ids = np.flatnonzero(band)
    if len(ids) == 0 or len(ids) > max_band:
        return labels
    remap = -np.ones(g.n, dtype=np.int64)
    remap[ids] = np.arange(len(ids))
    nb = len(ids)
    S_node, T_node = 2 * nb, 2 * nb + 1
    big = int(g.vwgt.sum()) + 1
    edges = []
    for i, v in enumerate(ids):
        edges.append([2 * i, 2 * i + 1, int(g.vwgt[v])])   # v_in → v_out
    inside = band[src] & band[g.adjncy]
    for e in np.flatnonzero(inside):                       # directed edges
        u, v = remap[src[e]], remap[g.adjncy[e]]
        edges.append([2 * u + 1, 2 * v, big])              # u_out → v_in
    touch_a = band[src] & ~band[g.adjncy] & (labels[g.adjncy] == 0)
    touch_b = band[src] & ~band[g.adjncy] & (labels[g.adjncy] == 1)
    for u in np.unique(src[touch_a]):
        edges.append([S_node, 2 * remap[u], big])
    for u in np.unique(src[touch_b]):
        edges.append([2 * remap[u] + 1, T_node, big])
    _, reach = R._dinic(2 * nb + 2, edges, S_node, T_node)
    in_r = reach[0:2 * nb:2]
    out_r = reach[1:2 * nb:2]
    new_labels = labels.copy()
    new_labels[ids] = np.where(in_r & out_r, 0,
                               np.where(in_r & ~out_r, SEP, 1))
    if (separator_weight(g, new_labels) < separator_weight(g, labels)
            and separator_is_feasible(g, new_labels, eps)
            and separator_invariant_ok(g, new_labels)):
        return new_labels
    return labels


def vertex_cover_polish(g: Graph, labels: np.ndarray,
                        eps: float) -> np.ndarray:
    """Replace S with a minimum vertex cover of a boundary bipartite graph.

    S is merged into one side, the resulting 2-way cut's König min-VC is
    extracted (the post-hoc construction, core/separator.py) and adopted iff
    it is lighter and feasible.  Both merge directions are tried.
    """
    from repro_torch.core.separator import separator_from_partition_pair
    labels = np.asarray(labels, dtype=np.int64)
    best = labels
    best_w = separator_weight(g, labels)
    for side in (0, 1):
        part2 = np.where(labels == (1 - side), 1 - side, side)
        sep = separator_from_partition_pair(g, part2, 0, 1)
        cand = part2.copy()
        cand[sep] = SEP
        w = separator_weight(g, cand)
        if (w < best_w and separator_is_feasible(g, cand, eps)
                and separator_invariant_ok(g, cand)):
            best, best_w = cand, w
    return best
