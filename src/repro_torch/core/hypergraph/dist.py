"""parhyp — distributed-memory multilevel hypergraph partitioning on a
`core.mesh.Mesh`, the hypergraph sibling of core/parhip.py.

The MPI design of ParHIP carries over to hypergraphs with one twist: the
unit of distribution is the *net*, not the vertex.  Nets (and all their
pins) are block-distributed over the ``nets`` mesh axis as padded
per-shard pin lists; on a 2-D ``(nets, verts)`` mesh each net row is
additionally split by the pin's *vertex column*, so the (n, k)
gain/affinity scatters shrink per rank.  Rank r holds shard r (nets-major:
shard ``ie·s_verts + jv`` at mesh position (ie, jv)); vertex labels stay
replicated on every rank.  Each refinement round:

  1. every rank counts its local pins into a per-(net, block) partial
     Φ(e_rows, b) — the pin-count kernel (``kernels/ops.pin_count_csr``)
     on the shard's pin list on a card, a COO scatter on the CPU — and
     the partials ``psum`` over ``verts`` into the net-sharded histogram;
     per-row objectives psum over ``nets``;
  2. exact (λ−1) / cut-net move gains are derived from Φ — the
     per-vertex affinity/removal partials are local scatters into the
     rank's vertex *column*, psum'd over ``nets`` only (a net's pins for
     one column all live on one rank, so its contribution is computed
     exactly once);
  3. moves are proposed with the same noise/parity split as the
     sequential refiner, and each rank applies capped acceptance on its
     *owned vertex slice* against its share of the global remaining
     capacity; the owned slices are then all-gathered into the replicated
     labels (owned slice of (ie, jv) at ``jv·n_col + ie·rows_v``).

Φ and the pin-count kernel: the shard's live pins are grouped by net in
ascending net order — at level 0 that is `shard_hypergraph`'s global pin
order, at coarser levels the contraction's dead-last ``(dead, net,
vertex)`` sort — so each level carries the shard's net offsets ``eptr``
(a count of the live pins per local net, then a cumulative sum: on the
host at level 0, on the device when a level is contracted).  The
contraction turns merged duplicate pins into mask-0 pins *inside* their
net's range; the kernel and the scatter both weight every pin by its
mask, so both routes give the same integer counts.

Coarsening is device-resident too: a distributed LP-clustering round
(deterministic min-label tie-breaks, integer fixed-point ratings so every
psum is order-independent) proposes column-local clusters, and a
contraction step rebuilds the rank's pin list — same padded shapes at
every level — without a host round trip.  The only host pulls per level
are the coarse-vertex count and the live-pin bound.

With one rank the refinement round is bit-identical to the sequential
scan (`refine._hyper_refine_scan_batch` on the COO path) given the same
draws: same pin layout, same scatter orders, same capped acceptance.
Noise is an argument: a (rounds, n_pad, k_pad) tensor (the tests hand in
the JAX package's ``uniform(key_r, (n_pad, k))`` draws), or one generator
seeded ``row_seed(seed, 0)`` — from the seed alone, never the rank, so
every rank draws the same full-width noise and slices its column; that is
why the mesh layouts refine identically.

The JAX package's ``ML.note_program`` (a compiled-program registry) has
no counterpart here: there is no compilation to track.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import lp as lp_mod
from repro_torch.core import multilevel as ML
from repro_torch.core.csr import _pow2_pad
from repro_torch.core.mesh import Mesh, device_of
from repro_torch.core.refine import _round_noise, default_use_kernel, row_seed
from repro_torch.core.hypergraph import metrics as M
from repro_torch.core.hypergraph.container import Hypergraph
from repro_torch.core.hypergraph.coarsen import RATING_SCALE
from repro_torch.core.hypergraph.driver import PRESETS, HypergraphMedium
from repro_torch.core.hypergraph.refine import (_caps_for, _pad_caps,
                                                k_bucket, refine_hypergraph)

# psums issued per distributed refinement round in the JAX package: the
# Φ(e,b) histogram plus two gain partials (aff/rem for km1, joins/breaks
# for cut-net); the port sends each pair of gain partials as one tensor
_PSUMS_PER_ROUND = 3

_NEG = lp_mod._NEG
_GAIN_EPS = lp_mod._GAIN_EPS
_STALL = 0.95          # stop coarsening when a level shrinks less than this
_POLISH_N = 65536      # sequential polish cutoff on the device path
# Below this size the whole problem goes to the host-orchestrated path, as
# ParHIP gathers a small-enough subproblem onto one PE: data-parallel LP
# clustering pays a few percent cluster impurity that a tiny hierarchy has
# too few levels to refine away, while at scale the loss amortises.
_DEVICE_MIN_N = 8192


# ---------------------------------------------------------------------------
# host container: net/vertex-block-distributed pin COO
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedHypergraph:
    """Host container: nets block-distributed over ``s_nets`` row groups and
    pins additionally split over ``s_verts`` vertex columns; each of the
    ``S = s_nets·s_verts`` shards holds one padded pin-COO row.  Net/vertex
    weight vectors are replicated.

    Shard ``ie·s_verts + jv`` owns the pins of net rows
    [ie·e_rows, (ie+1)·e_rows) whose vertex lies in column
    [jv·n_col, (jv+1)·n_col).  Padding pins are (net ``e_pad-1``, vertex
    ``n_pad-1``, mask 0) on a zero-weight net — the `PinCoo` convention, so
    with one shard the layout is exactly ``to_pincoo``'s.
    """

    pv: np.ndarray      # (S, p_shard) int32 — pin's vertex (global id)
    pe: np.ndarray      # (S, p_shard) int32 — pin's net (global id)
    mask: np.ndarray    # (S, p_shard) f32   — 1 real, 0 padding
    netw: np.ndarray    # (e_pad,) f32 — net weights, 0 padding (replicated)
    esize: np.ndarray   # (e_pad,) f32 — pin counts, 0 padding (replicated)
    vwgt: np.ndarray    # (n_pad,) f32 — vertex weights, 0 pad (replicated)
    n: int
    m: int
    rows_v: int         # vertices owned per shard (n_pad == S * rows_v)
    s_nets: int = 1     # mesh extent over net rows
    s_verts: int = 1    # mesh extent over vertex columns

    @property
    def n_shards(self) -> int:
        return self.pv.shape[0]

    @property
    def p_shard(self) -> int:
        return self.pv.shape[1]

    @property
    def n_pad(self) -> int:
        return len(self.vwgt)

    @property
    def e_pad(self) -> int:
        return len(self.netw)

    @property
    def n_col(self) -> int:
        """Vertices per column (n_pad == s_verts · n_col)."""
        return self.n_pad // self.s_verts

    @property
    def e_rows(self) -> int:
        """Nets per row group (e_pad == s_nets · e_rows)."""
        return self.e_pad // self.s_nets


def shard_hypergraph(hg: Hypergraph, shards, p_mult: int = 256,
                     n_mult: int = 128, e_mult: int = 128
                     ) -> ShardedHypergraph:
    """Block-distribute ``hg`` over ``shards`` = S (1-D over nets) or
    ``(s_nets, s_verts)`` (2-D): net-row group ie owns the contiguous
    net-id range [ie·e_rows, (ie+1)·e_rows), vertex column jv the vertex
    range [jv·n_col, (jv+1)·n_col); shard ie·s_verts+jv holds their
    intersection's pins in global pin order."""
    if isinstance(shards, tuple):
        s_nets, s_verts = shards
    else:
        s_nets, s_verts = int(shards), 1
    S = s_nets * s_verts
    n, m, p = hg.n, hg.m, hg.pins
    n_pad = _pow2_pad(max(n, 1), n_mult)
    rows_v = -(-n_pad // S)
    n_pad = rows_v * S
    n_col = rows_v * s_nets
    e_pad = _pow2_pad(m + 1, e_mult)
    e_rows = -(-e_pad // s_nets)
    e_pad = e_rows * s_nets
    pe_h = hg.pin_sources()
    owner_e = np.minimum(pe_h // e_rows, s_nets - 1)
    col_v = np.minimum(hg.eind // n_col, s_verts - 1)
    owner = owner_e * s_verts + col_v
    pmax = int(np.bincount(owner, minlength=S).max()) if p else 1
    p_shard = _pow2_pad(max(pmax, 1), p_mult)
    pv = np.full((S, p_shard), n_pad - 1, dtype=np.int32)
    pe = np.full((S, p_shard), e_pad - 1, dtype=np.int32)
    mask = np.zeros((S, p_shard), dtype=np.float32)
    for s in range(S):
        ids = np.flatnonzero(owner == s)
        pv[s, :len(ids)] = hg.eind[ids]
        pe[s, :len(ids)] = pe_h[ids]
        mask[s, :len(ids)] = 1.0
    netw = np.zeros(e_pad, dtype=np.float32)
    netw[:m] = hg.ewgt
    esize = np.zeros(e_pad, dtype=np.float32)
    esize[:m] = hg.net_sizes()
    vwgt = np.zeros(n_pad, dtype=np.float32)
    vwgt[:n] = hg.vwgt
    return ShardedHypergraph(pv=pv, pe=pe, mask=mask, netw=netw,
                             esize=esize, vwgt=vwgt, n=n, m=m, rows_v=rows_v,
                             s_nets=s_nets, s_verts=s_verts)


# ---------------------------------------------------------------------------
# this rank's place in the layout, and its level state on the device
# ---------------------------------------------------------------------------

def _mesh_axes(mesh: Mesh) -> Tuple[str, Optional[str]]:
    names = mesh.axis_names
    if len(names) == 1:
        return names[0], None
    if len(names) == 2:
        return names[0], names[1]
    raise ValueError(f"parhyp mesh must be 1-D (nets) or 2-D (nets, verts); "
                     f"got axes {names}")


def _mesh_extents(mesh: Mesh) -> Tuple[int, int]:
    ax_n, ax_v = _mesh_axes(mesh)
    return mesh.extent(ax_n), mesh.extent(ax_v)


@dataclasses.dataclass(frozen=True)
class _Layout:
    """The shard geometry of ``sh`` seen from this rank of ``mesh``."""
    mesh: Mesh
    ax_n: str
    ax_v: Optional[str]
    s_nets: int
    s_verts: int
    ie: int             # this rank's net-row group
    jv: int             # this rank's vertex column
    rows_v: int
    n_col: int
    e_rows: int
    n_pad: int
    e_pad: int

    @property
    def shard(self) -> int:
        return self.ie * self.s_verts + self.jv

    @property
    def me(self) -> int:
        """The index of this rank's owned vertex block (column-major)."""
        return self.jv * self.s_nets + self.ie

    def col(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's vertex column of a replicated (n_pad, ...) vector."""
        return x[self.jv * self.n_col:(self.jv + 1) * self.n_col]

    def owned(self, x_col: torch.Tensor) -> torch.Tensor:
        """This rank's owned slice of a column vector."""
        off = self.ie * self.rows_v
        return x_col[off:off + self.rows_v]

    def replicate(self, own: torch.Tensor) -> torch.Tensor:
        """All-gather the owned slices into the replicated vector: rank
        order (ie, jv) is permuted to the column-major block order."""
        full = self.mesh.all_gather(own)
        if self.s_nets > 1 and self.s_verts > 1:
            full = full.view(self.s_nets, self.s_verts, self.rows_v
                             ).transpose(0, 1).reshape(-1)
        return full


def _layout(mesh: Mesh, sh: ShardedHypergraph) -> _Layout:
    ax_n, ax_v = _mesh_axes(mesh)
    s_nets, s_verts = _mesh_extents(mesh)
    if (sh.s_nets, sh.s_verts) != (s_nets, s_verts):
        raise ValueError(f"sharded for ({sh.s_nets}, {sh.s_verts}), mesh is "
                         f"({s_nets}, {s_verts})")
    return _Layout(mesh, ax_n, ax_v, s_nets, s_verts, mesh.axis_index(ax_n),
                   mesh.axis_index(ax_v), sh.rows_v, sh.n_col, sh.e_rows,
                   sh.n_pad, sh.e_pad)


@dataclasses.dataclass
class _DeviceLevel:
    """One hierarchy level on this rank: its shard's pin list (net e's
    pins ``pv[eptr[e]:eptr[e+1]]`` by local net id), the replicated
    vectors, and after contraction the fine → coarse id map."""
    pv: torch.Tensor        # (p,) int32 — global vertex ids
    pe: torch.Tensor        # (p,) int32 — global net ids
    mask: torch.Tensor      # (p,) f32
    eptr: torch.Tensor      # (e_rows + 1,) int32 local net offsets
    netw: torch.Tensor      # (e_pad,) f32
    esize: torch.Tensor     # (e_pad,) f32
    vwgt: torch.Tensor      # (n_pad,) f32
    coarse_of: Optional[torch.Tensor] = None   # fine vertex → coarse id


def _eptr(pe_loc: torch.Tensor, live: torch.Tensor,
          e_rows: int) -> torch.Tensor:
    """Local net offsets of a net-grouped pin list: a count of the live
    pins per local net, then a cumulative sum (no host sync)."""
    cnt = torch.zeros(e_rows, dtype=torch.int64, device=pe_loc.device)
    cnt.index_add_(0, pe_loc.long(), live.long())
    out = torch.zeros(e_rows + 1, dtype=torch.int32, device=pe_loc.device)
    out[1:] = torch.cumsum(cnt, 0)
    return out


def _level0(lay: _Layout, sh: ShardedHypergraph, dev) -> _DeviceLevel:
    s = lay.shard
    pe_loc = np.clip(sh.pe[s] - lay.ie * lay.e_rows, 0, lay.e_rows - 1)
    cnt = np.bincount(pe_loc[sh.mask[s] > 0], minlength=lay.e_rows)
    eptr = np.zeros(lay.e_rows + 1, dtype=np.int32)
    eptr[1:] = np.cumsum(cnt)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return _DeviceLevel(put(sh.pv[s]), put(sh.pe[s]), put(sh.mask[s]),
                        put(eptr), put(sh.netw), put(sh.esize),
                        put(sh.vwgt))


# ---------------------------------------------------------------------------
# the distributed refinement round
# ---------------------------------------------------------------------------

def _pin_counts(lay: _Layout, L: _DeviceLevel, labels: torch.Tensor,
                k: int, use_kernel: bool) -> torch.Tensor:
    """This rank's (e_rows, k) Φ partial: the pin-count kernel on the
    shard's pin list, or the COO scatter."""
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.pin_count_csr(L.eptr, L.pv, L.mask, labels[None], k)[0]
    pe_loc = (L.pe - lay.ie * lay.e_rows).clamp(0, lay.e_rows - 1)
    idx = pe_loc.long() * k + labels[L.pv.long()].long()
    cnt = torch.zeros(lay.e_rows * k, dtype=torch.float32,
                      device=labels.device).index_add_(0, idx, L.mask)
    return cnt.view(lay.e_rows, k)


def _dist_obj(lay: _Layout, L: _DeviceLevel, cnt: torch.Tensor,
              objective: str) -> torch.Tensor:
    """Replicated objective from the verts-psum'd net-sharded Φ."""
    off = lay.ie * lay.e_rows
    obj_fn = M.km1_device if objective == "km1" else M.cut_net_device
    obj = obj_fn(cnt[None], L.netw[off:off + lay.e_rows])
    return lay.mesh.psum(obj, lay.ax_n)[0]


def _dist_wtot(lay: _Layout, L: _DeviceLevel) -> torch.Tensor:
    """Per-vertex total incident net weight W(v), psum'd over both axes —
    round-invariant, so it is computed once before the rounds."""
    w_pin = L.mask * L.netw[L.pe.long()]
    wtot = torch.zeros(lay.n_pad, dtype=torch.float32,
                       device=w_pin.device).index_add_(0, L.pv.long(), w_pin)
    return lay.mesh.psum(lay.mesh.psum(wtot, lay.ax_v), lay.ax_n)


def _dist_round(lay: _Layout, L: _DeviceLevel, wtot, labels, sizes, cap,
                noise, parity: int, force, k: int, objective: str,
                use_kernel: bool):
    """One distributed LP round on this rank: returns (new labels of the
    owned vertex slice, the pre-move objective).  The gain arithmetic
    mirrors refine._hyper_refine_scan_batch, so the one-rank round is
    bit-identical to the sequential scan."""
    mesh = lay.mesh
    dev = labels.device
    n_col = lay.n_col
    pv, pe = L.pv.long(), L.pe.long()
    lab_pin = labels[pv].long()
    # clamped local indices: padding pins (mask 0) may clamp anywhere —
    # every use below is mask-weighted (the kernels/ops.py masking contract)
    pe_loc = (pe - lay.ie * lay.e_rows).clamp(0, lay.e_rows - 1)
    pv_loc = (pv - lay.jv * n_col).clamp(0, n_col - 1)
    w_pin = L.mask * L.netw[pe]
    cnt = mesh.psum(_pin_counts(lay, L, labels, k, use_kernel), lay.ax_v)
    obj = _dist_obj(lay, L, cnt, objective)
    # exact move gains from the net-sharded histogram (per-vertex partials
    # from local pins into this rank's column, psum'd over nets — each
    # net's pins for one column all live on one rank); the vertex-side
    # and block-side partials travel as one (n_col, k + 1) tensor
    cnt_e = cnt[pe_loc]                                   # (p, k)
    cnt_own = cnt_e.gather(1, lab_pin[:, None])[:, 0]
    if objective == "km1":
        per_block = w_pin[:, None] * (cnt_e > 0).to(torch.float32)
        per_vertex = w_pin * (cnt_own == 1)
    else:
        esz = L.esize[pe]
        per_block = w_pin[:, None] * (cnt_e == (esz - 1.0)[:, None]).to(
            torch.float32)
        per_vertex = w_pin * (cnt_own == esz)
    part = torch.zeros(n_col, k + 1, dtype=torch.float32, device=dev)
    part.index_add_(0, pv_loc, torch.cat([per_block, per_vertex[:, None]],
                                         1))
    part = mesh.psum(part, lay.ax_n)
    if objective == "km1":
        gain = part[:, k:] - lay.col(wtot)[:, None] + part[:, :k]
    else:
        gain = part[:, :k] - part[:, k:]
    # full-width noise sliced to the column: identical values per vertex on
    # every mesh layout (the layout-parity anchor)
    gain = gain + lay.col(noise)
    labels_col = lay.col(labels)
    vw_col = lay.col(L.vwgt)
    lab = labels_col.long()
    gain.scatter_(1, lab[:, None], _NEG)
    room = sizes[None, :] + vw_col[:, None] <= cap[None, :]
    gain = torch.where(room, gain, _NEG)
    best_gain = gain.amax(1)
    best_tgt = gain.argmax(1).to(labels.dtype)        # first maximum, as jnp
    want = best_gain > _GAIN_EPS
    over = sizes[lab] > cap[lab]
    want = want | (force & over & (best_gain > _NEG / 2) & (vw_col > 0))
    node_ids = lay.jv * n_col + torch.arange(n_col, device=dev)
    want = want & ((node_ids + parity) % 2 == 0)
    proposal = torch.where(want, best_tgt, labels_col)
    pri = torch.where(want, best_gain, _NEG)
    # Per-rank capped acceptance on the owned vertex slice against the
    # global size constraint.  The split of the remaining room is
    # contention-aware: per block, if the global proposed inflow (demand —
    # proposals are nets-replicated, so one verts-psum makes it global)
    # fits the room, every rank may accept (total <= demand <= room);
    # otherwise only a rotating owner rank gets the room (total <= room).
    # With one rank the owner is always rank 0, so the round stays
    # bit-identical to the sequential scan.
    vw_mov = torch.where(proposal != labels_col, vw_col, 0.0)
    demand = mesh.psum(torch.zeros(k, dtype=torch.float32, device=dev
                                   ).index_add_(0, proposal.long(), vw_mov),
                       lay.ax_v)
    uncontended = demand <= cap - sizes
    owner_b = ((torch.arange(k, device=dev) + parity)
               % (lay.s_nets * lay.s_verts) == lay.me)
    cap_local = torch.where(uncontended | owner_b, cap, sizes)
    new_own = lp_mod.capped_accept(
        lay.owned(labels_col)[None], lay.owned(proposal)[None],
        lay.owned(vw_col), sizes[None], cap_local, lay.owned(pri)[None])[0]
    return new_own, obj


def _parhyp_refine(lay: _Layout, L: _DeviceLevel, labels0: torch.Tensor,
                   cap: torch.Tensor, noise: lp_mod.Noise, force: bool,
                   k: int, rounds: int, objective: str, use_kernel: bool):
    """The distributed refinement scan with undo-to-best.  ``labels0``
    (n_pad,) int32 replicated; ``noise`` the draws of `_noise_of` (the
    same on every rank).  Returns (labels, best objective, feasible) as
    device tensors; no host sync inside."""
    dev = labels0.device
    wtot = _dist_wtot(lay, L)

    def sizes_of(labels):
        return torch.zeros(k, dtype=torch.float32, device=dev).index_add_(
            0, labels.long(), L.vwgt)

    def track(labels, sizes, obj, best_obj, best_labels):
        """Undo-to-best: keep the best feasible state seen."""
        better = ((sizes - cap).amax() <= 1e-6) & (obj < best_obj)
        return (torch.where(better, obj, best_obj),
                torch.where(better, labels, best_labels))

    labels, sizes = labels0, sizes_of(labels0)
    best_labels = labels0
    best_obj = torch.tensor(torch.inf, dtype=torch.float32, device=dev)
    for parity in range(rounds):
        nz = _round_noise(noise, parity, lay.n_pad, k, dev)[0]
        own, obj = _dist_round(lay, L, wtot, labels, sizes, cap, nz, parity,
                               force, k, objective, use_kernel)
        best_obj, best_labels = track(labels, sizes, obj, best_obj,
                                      best_labels)
        labels = lay.replicate(own)
        sizes = sizes_of(labels)
    # evaluate the final state too
    cnt = lay.mesh.psum(_pin_counts(lay, L, labels, k, use_kernel), lay.ax_v)
    best_obj, best_labels = track(labels, sizes,
                                  _dist_obj(lay, L, cnt, objective),
                                  best_obj, best_labels)
    out = torch.where(torch.isfinite(best_obj), best_labels, labels)
    out_feas = (sizes_of(out) - cap).amax() <= 1e-6
    return out, best_obj, out_feas


def _caps(hg: Hypergraph, k: int, eps: float, dev) -> Tuple[int, torch.Tensor]:
    k_pad = k_bucket(k)
    return k_pad, torch.from_numpy(
        _pad_caps(_caps_for(hg, k, eps), k_pad)).to(dev)


def _noise_of(noise: Optional[torch.Tensor], seed: int, dev) -> lp_mod.Noise:
    """The draws of one scan as a batch of one row for `_round_noise`: a
    given (rounds, n_pad, k) tensor, or the generator every rank seeds
    from ``seed`` alone (the sequential scan's row 0 seed)."""
    if noise is not None:
        return noise.to(dev)[None]
    return [torch.Generator(device=dev).manual_seed(row_seed(seed, 0))]


def parhyp_refine(hg: Hypergraph, part: np.ndarray, k: int,
                  eps: float = 0.03, mesh: Optional[Mesh] = None,
                  rounds: int = 12, seed: int = 0, objective: str = "km1",
                  force_balance: bool = False, axis: str = "nets",
                  sh: Optional[ShardedHypergraph] = None,
                  noise: Optional[torch.Tensor] = None,
                  use_kernel: Optional[bool] = None,
                  device=None) -> np.ndarray:
    """Distributed k-way LP refinement of a hypergraph partition on
    ``mesh`` (None = a world of one on ``device``: None = CUDA).

    Never returns a worse feasible objective than the input (the caller's
    better-of-in/out guard, as in refine_hypergraph); ``sh`` accepts a
    cached `ShardedHypergraph` matching the mesh layout; ``noise`` a
    (rounds, n_pad, k_pad) tensor of draws; ``use_kernel=None`` counts
    pins with the CUDA kernel on a card and the COO scatter on the CPU.
    """
    if k <= 1 or hg.n == 0:
        return np.asarray(part, dtype=np.int64)
    dev = device_of(mesh, device)
    mesh = mesh if mesh is not None else Mesh.local((axis,), dev)
    s_nets, s_verts = _mesh_extents(mesh)
    use_kernel = default_use_kernel(dev) if use_kernel is None else use_kernel
    rec = obs.current()
    if sh is None or sh.s_nets != s_nets or sh.s_verts != s_verts:
        sh = shard_hypergraph(hg, (s_nets, s_verts))
    lay = _layout(mesh, sh)
    k_pad, cap = _caps(hg, k, eps, dev)
    labels0 = np.zeros(sh.n_pad, dtype=np.int32)
    labels0[:hg.n] = part
    with rec.span("parhyp_refine", n=hg.n, rounds=rounds,
                  shards=sh.n_shards):
        out, _, _ = _parhyp_refine(
            lay, _level0(lay, sh, dev), torch.from_numpy(labels0).to(dev),
            cap, _noise_of(noise, seed, dev), force_balance, k_pad, rounds,
            objective, use_kernel)
        out = out.cpu().numpy().astype(np.int64)[:hg.n]
    rec.count("parhyp/dist_rounds", rounds)
    # per round: Φ + two gain partials; plus the one-off wtot and final Φ
    rec.count("parhyp/psum_rounds", _PSUMS_PER_ROUND * rounds + 2)
    score = M.connectivity if objective == "km1" else M.cut_net
    if score(hg, out) <= score(hg, part) or force_balance:
        return out
    rec.count("parhyp/rounds_rejected")
    return np.asarray(part, dtype=np.int64)


# ---------------------------------------------------------------------------
# distributed LP-clustering coarsening
# ---------------------------------------------------------------------------

def _runs(*keys: torch.Tensor) -> torch.Tensor:
    """Run ids of a sorted sequence: a new run wherever any key changes."""
    newrun = torch.zeros(keys[0].shape[0], dtype=torch.bool,
                         device=keys[0].device)
    newrun[0] = True
    for key in keys:
        newrun[1:] |= key[1:] != key[:-1]
    return torch.cumsum(newrun, 0) - 1


def _cluster_round(lay: _Layout, L: _DeviceLevel, labels: torch.Tensor,
                   capv: torch.Tensor, parity: int) -> torch.Tensor:
    """One distributed LP-clustering round on this rank; returns the new
    labels of its owned vertex slice.

    Affinities use integer fixed-point ratings r(e) = max(1,
    round(SCALE·w/(|e|−1))) computed in place from the replicated net
    vectors — linear in pins (no clique expansion), and integer-valued so
    every cross-rank reduction is order-independent (exact).  Per net the
    two most frequent pin labels are found by a run-length lexsort + two
    masked scatter passes; each pin's candidate is the most frequent
    *other* label.  Tie-breaks are deterministic (min label), no RNG.
    Clusters are column-local by construction: candidates come from
    co-pins in the same vertex column, so a cluster never spans columns
    and contraction preserves the 2-D layout.
    """
    mesh = lay.mesh
    dev = labels.device
    n_pad, n_col, e_rows = lay.n_pad, lay.n_col, lay.e_rows
    p_loc = L.pv.shape[0]
    pv = L.pv.long()
    pe_loc = (L.pe.long() - lay.ie * e_rows).clamp(0, e_rows - 1)
    pv_loc = (pv - lay.jv * n_col).clamp(0, n_col - 1)
    off_e = lay.ie * e_rows
    netw_row = L.netw[off_e:off_e + e_rows]
    esize_row = L.esize[off_e:off_e + e_rows]
    rate_row = torch.where(
        (esize_row >= 2) & (netw_row > 0),
        torch.clamp(torch.round(RATING_SCALE * netw_row / torch.clamp(
            esize_row - 1.0, min=1.0)), min=1.0), 0.0)
    r_pin = L.mask * rate_row[pe_loc]
    live = r_pin > 0
    dead = (~live).to(torch.int32)
    lab_p = torch.where(live, labels[pv], n_pad)
    # pass 1: per-(net, label) run counts → per-net top-2 labels
    order = lp_mod.lexsort((lab_p, pe_loc, dead))
    pe_s = pe_loc[order]
    lab_s = lab_p[order]
    live_s = live[order]
    seg = _runs(pe_s, lab_s, live_s)
    rc = torch.zeros(p_loc, dtype=torch.float32, device=dev).index_add_(
        0, seg, live_s.to(torch.float32))
    rc_eff = torch.where(live_s, rc[seg], 0.0)

    def top(values, among):
        """Per net: the largest of ``values`` and the smallest label
        holding it, over the pins ``among`` marks."""
        best = torch.zeros(e_rows, dtype=torch.float32, device=dev
                           ).scatter_reduce_(0, pe_s, values, "amax")
        hit = among & (values == best[pe_s])
        lab = torch.full((e_rows,), n_pad, dtype=torch.int32, device=dev
                         ).scatter_reduce_(0, pe_s, torch.where(
                             hit, lab_s, n_pad), "amin")
        return best, lab

    t1c, t1l = top(rc_eff, live_s)
    not1 = live_s & (lab_s != t1l[pe_s])
    t2c, t2l = top(torch.where(not1, rc_eff, 0.0), not1)
    # back to pin order: own-run count, candidate label + its count
    rc_own = torch.zeros(p_loc, dtype=torch.float32, device=dev).scatter_(
        0, order, rc_eff)
    own_is_t1 = lab_p == t1l[pe_loc]
    cand = torch.where(own_is_t1, t2l[pe_loc], t1l[pe_loc])
    ccnt = torch.where(own_is_t1, t2c[pe_loc], t1c[pe_loc])
    cand = torch.where(live, cand, n_pad)
    own_aff = torch.zeros(n_col, dtype=torch.float32, device=dev).index_add_(
        0, pv_loc, r_pin * torch.clamp(rc_own - 1.0, min=0.0))
    # pass 2: aggregate candidate affinity per (vertex, candidate)
    has_cand = live & (cand < n_pad)
    dead2 = (~has_cand).to(torch.int32)
    order2 = lp_mod.lexsort((cand, pv_loc, dead2))
    pv2 = pv_loc[order2]
    cand_s = cand[order2]
    live2 = dead2[order2] == 0
    a_pin = torch.where(has_cand, r_pin * ccnt, 0.0)[order2]
    seg2 = _runs(pv2, cand_s, live2)
    aff_run = torch.zeros(p_loc, dtype=torch.float32, device=dev).index_add_(
        0, seg2, a_pin)[seg2]
    # size-constrained best candidate per vertex, min-label tie-break
    sizes_cl = torch.zeros(n_pad, dtype=torch.float32, device=dev
                           ).index_add_(0, labels.long(), L.vwgt)
    cand_c = cand_s.clamp(0, n_pad - 1).long()
    vglob = lay.jv * n_col + pv2
    room = sizes_cl[cand_c] + L.vwgt[vglob] <= capv[cand_c]
    g = aff_run - own_aff[pv2]
    g_eff = torch.where(live2 & room, g, _NEG)
    g_v = torch.full((n_col,), _NEG, dtype=torch.float32, device=dev
                     ).scatter_reduce_(0, pv2, g_eff, "amax")
    is_best = live2 & (g_eff == g_v[pv2])
    cand_v = torch.full((n_col,), n_pad, dtype=torch.int32, device=dev
                        ).scatter_reduce_(0, pv2, torch.where(
                            is_best, cand_s, n_pad), "amin")
    # cross-row combine (exact: affinities are integer-valued f32)
    g2 = mesh.pmax(g_v.clone(), lay.ax_n)
    cand2 = mesh.pmin(torch.where((g_v == g2) & (cand_v < n_pad), cand_v,
                                  n_pad), lay.ax_n)
    labels_col = lay.col(labels)
    vw_col = lay.col(L.vwgt)
    improve = ((g2 > _GAIN_EPS) & (cand2 < n_pad) & (vw_col > 0)
               & (cand2 != labels_col))
    node_ids = lay.jv * n_col + torch.arange(n_col, device=dev)
    want = improve & ((node_ids + parity) % 2 == 0)
    proposal = torch.where(want, cand2, labels_col).to(labels.dtype)
    pri = torch.where(want, g2, _NEG)
    # contention-aware capped acceptance, as in the refinement round, with
    # per-cluster ownership: a cluster is arbitrated inside its own vertex
    # column by a rotating net-row owner
    vw_mov = torch.where(proposal != labels_col, vw_col, 0.0)
    demand = mesh.psum(torch.zeros(n_pad, dtype=torch.float32, device=dev
                                   ).index_add_(0, proposal.long(), vw_mov),
                       lay.ax_v)
    uncontended = demand <= capv - sizes_cl
    cid = torch.arange(n_pad, device=dev)
    owner = ((cid + parity) % lay.s_nets == lay.ie) & (cid // n_col == lay.jv)
    cap_local = torch.where(uncontended | owner, capv, sizes_cl)
    return lp_mod.capped_accept(
        lay.owned(labels_col)[None], lay.owned(proposal)[None],
        lay.owned(vw_col), sizes_cl[None], cap_local,
        lay.owned(pri)[None])[0]


def _parhyp_cluster(lay: _Layout, L: _DeviceLevel, labels0, capv,
                    parity0: int, iters: int) -> torch.Tensor:
    """``iters`` clustering rounds; returns the replicated labels."""
    labels = labels0
    for it in range(iters):
        labels = lay.replicate(_cluster_round(lay, L, labels, capv,
                                              parity0 + it))
    return labels


def _compact_labels(labels: torch.Tensor, vwgt: torch.Tensor, n_col: int):
    """Replicated cluster-id compaction (every rank computes it alike).

    Coarse ids are assigned by a stable sort on (column, non-empty):
    within each vertex column, clusters with positive weight get the low
    contiguous ids — so the coarse level keeps the column structure (the
    recursive 2-D invariant) and the all-padding tail stays at the top.
    """
    n_pad = labels.shape[0]
    dev = labels.device
    cvw_l = torch.zeros(n_pad, dtype=torch.float32, device=dev).index_add_(
        0, labels.long(), vwgt)
    pr = cvw_l > 0
    col = torch.arange(n_pad, device=dev) // n_col
    key = col * (2 * n_col) + torch.where(pr, 0, n_col)
    perm = torch.sort(key, stable=True).indices
    newid = torch.zeros(n_pad, dtype=torch.int32, device=dev).scatter_(
        0, perm, torch.arange(n_pad, dtype=torch.int32, device=dev))
    coarse_of = newid[labels.long()]
    cvw = torch.zeros(n_pad, dtype=torch.float32, device=dev).index_add_(
        0, coarse_of.long(), vwgt)
    return coarse_of, cvw, pr.sum()


def _contract(lay: _Layout, L: _DeviceLevel, labels: torch.Tensor):
    """The coarse level of ``labels``'s clustering on this rank.

    Pins are remapped to coarse vertices, duplicates within a net merged
    by a (net, coarse-vertex) lexsort (dead pins sort last, so live pins'
    positions are padding-inert), and dropped pins turned into sentinel
    padding.  Single-pin and empty nets get weight 0 (parallel nets are
    kept separate — objective-neutral).  Shapes are unchanged.  The new
    offsets count the live pins per net before the duplicates are merged:
    a merged duplicate stays inside its net's range as a mask-0 pin.
    Returns (level, coarse_of, nc, hi) with nc the coarse vertex count and
    hi the largest live-pin count of any rank, both device scalars.
    """
    mesh = lay.mesh
    n_pad, e_pad = lay.n_pad, lay.e_pad
    coarse_of, cvw, nc = _compact_labels(labels, L.vwgt, lay.n_col)
    live = L.mask > 0
    pvn = torch.where(live, coarse_of[L.pv.long()], n_pad - 1)
    pe_loc = (L.pe - lay.ie * lay.e_rows).clamp(0, lay.e_rows - 1)
    order = lp_mod.lexsort((pvn, pe_loc, (~live).to(torch.int32)))
    pe_s = pe_loc[order]
    pvn_s = pvn[order]
    live_s = live[order]
    dup = torch.zeros_like(live_s)
    dup[1:] = ((pe_s[1:] == pe_s[:-1]) & (pvn_s[1:] == pvn_s[:-1])
               & live_s[1:] & live_s[:-1])
    keep = live_s & ~dup
    pv2 = torch.where(keep, pvn_s, n_pad - 1).to(torch.int32)
    pe2 = torch.where(keep, pe_s + lay.ie * lay.e_rows, e_pad - 1).to(
        torch.int32)
    mask2 = keep.to(torch.float32)
    esize_new = torch.zeros(e_pad, dtype=torch.float32, device=L.pv.device
                            ).index_add_(0, pe2.long(), mask2)
    esize_new = mesh.psum(mesh.psum(esize_new, lay.ax_v), lay.ax_n)
    netw2 = torch.where(esize_new >= 2, L.netw, 0.0)
    esize2 = torch.where(netw2 > 0, esize_new, 0.0)
    # every kept pin lives in the dead-last sort's live prefix, so the max
    # per-rank live count bounds the slice the pins may be compacted to
    hi = live.sum().to(torch.int32).reshape(1)
    hi = mesh.pmax(mesh.pmax(hi, lay.ax_v), lay.ax_n)[0]
    level = _DeviceLevel(pv2, pe2, mask2, _eptr(pe_s, live_s, lay.e_rows),
                         netw2, esize2, cvw)
    return level, coarse_of, nc, hi


# ---------------------------------------------------------------------------
# device-resident hierarchy
# ---------------------------------------------------------------------------

def _device_hierarchy(sh: ShardedHypergraph, mesh: Mesh, cfg, k: int,
                      seed: int, rec) -> Tuple[List[_DeviceLevel], int]:
    """Coarsen on the device until ~stop_n vertices remain (floored so the
    level count — and with it the pin memory — stays bounded on
    million-scale inputs).  The only host round trip per level is a pair
    of scalars (coarse-vertex count + live-pin bound); between levels the
    pin buffers are cut to the next pow2 bucket of the live-pin bound —
    the dead-last contraction sort leaves every kept pin in a per-rank
    prefix — so level cost shrinks geometrically with the hypergraph."""
    stop_n = ML.coarsen_stop_n(cfg, k)
    stop_dev = max(stop_n, min(4096, sh.n // 8))
    lay = _layout(mesh, sh)
    dev = mesh.device
    levels = [_level0(lay, sh, dev)]
    total_w = float(np.sum(sh.vwgt))
    max_cw = max(1.0, total_w / (cfg.cluster_weight_factor * k))
    labels0 = torch.arange(sh.n_pad, dtype=torch.int32, device=dev)
    capv = torch.full((sh.n_pad,), max_cw, dtype=torch.float32, device=dev)
    n_cur = sh.n
    lvl = 0
    while n_cur > stop_dev:
        L = levels[-1]
        p_cur = L.pv.shape[0]
        with rec.span("parhyp_coarsen", level=lvl, n=n_cur):
            labels = _parhyp_cluster(lay, L, labels0, capv, lvl,
                                     cfg.lp_iters)
            coarse, coarse_of, nc, hi = _contract(lay, L, labels)
            nc_i, hi_i = (int(v) for v in torch.stack(
                [nc.to(torch.int64), hi.to(torch.int64)]).tolist())
        if nc_i >= n_cur * _STALL:
            break
        p_new = _pow2_pad(max(hi_i, 1), 256)
        if p_new < p_cur:
            coarse.pv, coarse.pe, coarse.mask = (
                a[:p_new] for a in (coarse.pv, coarse.pe, coarse.mask))
        L.coarse_of = coarse_of
        levels.append(coarse)
        n_cur = nc_i
        lvl += 1
    rec.count("parhyp/device_levels", len(levels))
    return levels, n_cur


def _extract_coarsest(pv: np.ndarray, pe: np.ndarray, mask: np.ndarray,
                      netw: np.ndarray, vwgt: np.ndarray
                      ) -> Tuple[Hypergraph, np.ndarray]:
    """The coarsest level as a host `Hypergraph`, from every shard's pins
    concatenated in shard order.

    Returns (hg, ids) where ids[c] is the device vertex id of host vertex
    c — the scatter map that seeds the device uncoarsening from the host
    initial partition."""
    live = (mask > 0) & (netw[pe] > 0)
    real = vwgt > 0
    real[pv[live]] = True
    ids = np.flatnonzero(real)
    remap = np.full(len(vwgt), 0, np.int64)
    remap[ids] = np.arange(len(ids))
    pe_l = pe[live]
    pv_l = remap[pv[live]]
    order = np.argsort(pe_l, kind="stable")
    pe_s, pv_s = pe_l[order], pv_l[order]
    cnt = np.bincount(pe_s, minlength=len(netw))
    keepnet = (cnt >= 2) & (netw > 0)
    keep_pin = keepnet[pe_s]
    pv_s = pv_s[keep_pin]
    nid = np.flatnonzero(keepnet)
    eptr = np.concatenate([[0], np.cumsum(cnt[nid])]).astype(np.int64)
    hg = Hypergraph.from_arrays(len(ids), eptr, pv_s,
                                ewgt=netw[nid].astype(np.int64),
                                vwgt=np.maximum(vwgt[ids], 1).astype(
                                    np.int64))
    return hg, ids


def _gather_level(mesh: Mesh, L: _DeviceLevel):
    """(pv, pe, mask, netw, vwgt) of every shard on the host."""
    def host(t):
        return t.cpu().numpy()
    return (host(mesh.all_gather(L.pv)), host(mesh.all_gather(L.pe)),
            host(mesh.all_gather(L.mask)), host(L.netw), host(L.vwgt))


# ---------------------------------------------------------------------------
# the parhyp program
# ---------------------------------------------------------------------------

PARHYP_PRESETS = {
    "ultrafast": dict(preset="fast", rounds=4),
    "fast":      dict(preset="fast", rounds=8),
    "eco":       dict(preset="eco", rounds=12),
}


def _parhyp_host(hg: Hypergraph, k: int, eps: float, cfg, rounds: int,
                 seed: int, mesh: Mesh, objective: str, use_kernel: bool,
                 rec) -> np.ndarray:
    """Host-orchestrated multilevel path (small inputs / stalled
    coarsening): hierarchy + initial-partition tournament from
    `HypergraphMedium`, the distributed LP round as the refinement engine
    at every level, the sequential force-balance refiner as the repair."""
    levels = ML.build_hierarchy(
        HypergraphMedium(hg, cfg, objective, device=mesh.device), k, seed)
    part = ML.initial_partition(levels[-1], k, eps, seed)

    def refine_level(medium, part: np.ndarray, li: int) -> np.ndarray:
        fine = medium.hg
        part = parhyp_refine(fine, part, k, eps, mesh, rounds=rounds,
                             seed=seed + li, objective=objective,
                             use_kernel=use_kernel)
        if not M.is_feasible(fine, part, k, eps):
            part = refine_hypergraph(fine, part, k, eps, rounds=6,
                                     seed=seed + li, objective=objective,
                                     force_balance=True,
                                     use_kernel=use_kernel, hc=medium.views)
            rec.count("parhyp/repairs")
        return part

    score = M.connectivity if objective == "km1" else M.cut_net
    for li in range(len(levels) - 1, 0, -1):
        part = part[levels[li].cl]
        medium = levels[li - 1].medium
        with rec.span("parhyp_level", level=li - 1, n=medium.n):
            part = refine_level(medium, part, li)
        if rec.enabled:
            rec.point("parhyp", level=li - 1,
                      objective=float(score(medium.hg, part)))
    if len(levels) == 1:
        # single-level hierarchy: the loop above is empty — still refine
        # and repair at level 0
        with rec.span("parhyp_level", level=0, n=hg.n):
            part = refine_level(levels[0].medium, part, 0)
        if rec.enabled:
            rec.point("parhyp", level=0, objective=float(score(hg, part)))
    return part


def _parhyp_device(hg: Hypergraph, k: int, eps: float, cfg, rounds: int,
                   seed: int, mesh: Mesh, objective: str, use_kernel: bool,
                   rec) -> Optional[np.ndarray]:
    """Device-resident V-cycle: coarsen → (host) initial partition on the
    coarsest → uncoarsen-refine, all level state staying on the device.

    Returns None when coarsening stalls immediately (the caller falls back
    to the host-orchestrated path)."""
    dev = mesh.device
    s_nets, s_verts = _mesh_extents(mesh)
    sh = shard_hypergraph(hg, (s_nets, s_verts))
    lay = _layout(mesh, sh)
    levels, _ = _device_hierarchy(sh, mesh, cfg, k, seed, rec)
    if len(levels) == 1:
        return None
    hg_c, ids = _extract_coarsest(*_gather_level(mesh, levels[-1]))
    with rec.span("parhyp_initial", n=hg_c.n, k=k):
        part_c = ML.multilevel(HypergraphMedium(hg_c, cfg, objective,
                                                device=dev), k, eps, seed)
    k_pad, cap = _caps(hg, k, eps, dev)
    lab_h = np.zeros(sh.n_pad, dtype=np.int32)
    lab_h[ids] = part_c
    labels = torch.from_numpy(lab_h).to(dev)
    score = M.connectivity if objective == "km1" else M.cut_net
    for li in range(len(levels) - 2, -1, -1):
        L = levels[li]
        labels = labels[L.coarse_of.long()]
        with rec.span("parhyp_level", level=li):
            out, obj, feas = _parhyp_refine(
                lay, L, labels, cap, _noise_of(None, seed + li, dev), False,
                k_pad, rounds, objective, use_kernel)
            rec.count("parhyp/dist_rounds", rounds)
            rec.count("parhyp/psum_rounds", _PSUMS_PER_ROUND * rounds + 2)
            if not bool(feas):
                # forced-balance repair on the SAME device level —
                # no re-sharding from the host container
                out, obj, feas = _parhyp_refine(
                    lay, L, out, cap, _noise_of(None, seed + li + 7919, dev),
                    True, k_pad, rounds, objective, use_kernel)
                rec.count("parhyp/repairs")
        labels = out
        if rec.enabled:
            rec.point("parhyp", level=li, objective=float(obj))
    part = labels.cpu().numpy().astype(np.int64)[:hg.n]
    if not M.is_feasible(hg, part, k, eps):
        # last-resort host repair (forced balance never worsens feasibly)
        part = refine_hypergraph(hg, part, k, eps, rounds=6, seed=seed,
                                 objective=objective, force_balance=True,
                                 use_kernel=use_kernel, device=dev)
        rec.count("parhyp/repairs")
    elif hg.n <= _POLISH_N:
        # small instances: one sequential polish pass (never-worse guard
        # inside) — quality insurance where its cost is negligible
        part = refine_hypergraph(hg, part, k, eps, rounds=6, seed=seed,
                                 objective=objective, use_kernel=use_kernel,
                                 device=dev)
    if rec.enabled:
        rec.point("parhyp", level=0, objective=float(score(hg, part)))
    return part


def parhyp(hg: Hypergraph, k: int, eps: float = 0.03,
           preconfiguration: str = "fast", seed: int = 0,
           mesh: Optional[Mesh] = None, objective: str = "km1",
           report=None, use_kernel: Optional[bool] = None,
           device=None) -> np.ndarray:
    """The ``parhyp`` program: distributed multilevel hypergraph
    partitioning on ``mesh`` — 1-D ``("nets",)`` or 2-D ``("nets",
    "verts")`` — or, with ``mesh=None``, a world of one on ``device``
    (None = CUDA, raising without a card unless ``device="cpu"``).

    Device-resident V-cycle (distributed LP-clustering coarsening, host
    initial partition on the coarsest level only, distributed LP
    uncoarsening-refinement) for inputs above ``_DEVICE_MIN_N`` (the
    ParHIP gather-to-one-PE floor); the
    host-orchestrated multilevel on the shared engine remains the path
    for small inputs and the fallback for stalled coarsening.  Every rank
    runs the host steps alike (the same seeds on the same device type),
    so the result is replicated.  ``use_kernel=None`` counts pins with the
    CUDA kernel on a card (``False``: the plain scatter everywhere).
    ``report`` is an optional ``obs.Recorder`` capturing the distributed
    rounds, psum counts, coarsening spans and per-level quality.
    """
    if objective not in ("km1", "cut"):
        raise ValueError(f"unknown objective {objective!r}")
    dev = device_of(mesh, device)
    if k <= 1:
        return np.zeros(hg.n, dtype=np.int64)
    mesh = mesh if mesh is not None else Mesh.local(("nets",), dev)
    _mesh_axes(mesh)
    use_kernel = default_use_kernel(dev) if use_kernel is None else use_kernel
    pc = PARHYP_PRESETS[preconfiguration]
    cfg = dataclasses.replace(PRESETS[pc["preset"]], use_kernel=use_kernel)
    rounds = pc["rounds"]
    with obs.use(report):
        rec = obs.current()
        with rec.span("parhyp", n=hg.n, k=k,
                      preconfiguration=preconfiguration):
            part = None
            if hg.n > max(ML.coarsen_stop_n(cfg, k), _DEVICE_MIN_N):
                part = _parhyp_device(hg, k, eps, cfg, rounds, seed, mesh,
                                      objective, use_kernel, rec)
            if part is None:
                part = _parhyp_host(hg, k, eps, cfg, rounds, seed, mesh,
                                    objective, use_kernel, rec)
    return part
