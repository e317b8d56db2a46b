"""ParHIP — distributed-memory parallel partitioning (paper §2.5) on a
`core.mesh.Mesh`.

The MPI design of ParHIP maps onto one process per rank:

  * nodes (and their out-edges) are block-distributed over the mesh axis
    ``nodes`` — exactly ParHIP's vertex distribution; rank s holds shard
    s of `shard_graph`;
  * each LP round reads the *replicated* label vector, computes new labels
    for its owned nodes only, and enforces the size constraint with a
    per-shard slice of the *global* remaining capacity (the block sizes
    are computed from the replicated labels on every rank) — so the
    constraint holds globally without a sequential arbiter;
  * the owned labels are all-gathered into the replicated vector after
    every round (the ghost-label exchange; in the JAX package, the
    all-gather SPMD partitioning inserts).

The same round serves k-way refinement at every level of a hierarchy
that every rank builds alike.  Preconfigurations {ultrafast, fast,
eco}×{mesh, social} select rounds/iterations (§4.3.1).

Tie-break noise is an argument: a (rounds, rows, k) tensor of this
rank's draws (the tests hand in the JAX package's, ``uniform(fold_in(
key_r, shard), (rows, k))``), or, in production, one torch.Generator per
rank seeded from ``row_seed(seed, rank)`` alone.  The round's affinity is
a COO ``index_add_`` over the shard's edges, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import kaffpa as K
from repro_torch.core import lp as lp_mod
from repro_torch.core import multilevel as ML
from repro_torch.core import refine as R
from repro_torch.core.csr import Graph, _pow2_pad
from repro_torch.core.mesh import Mesh, device_of
from repro_torch.core.partition import edge_cut, is_feasible

_NEG = lp_mod._NEG
_GAIN_EPS = lp_mod._GAIN_EPS


@dataclasses.dataclass
class ShardedGraph:
    """Host container: node-block-distributed COO (global ids)."""
    src: np.ndarray     # (S, emax) int32, padding points at row 0 w/ w=0
    dst: np.ndarray     # (S, emax) int32
    w: np.ndarray       # (S, emax) float32
    vwgt: np.ndarray    # (S, rows) float32
    n: int
    rows: int

    @property
    def n_shards(self) -> int:
        return self.src.shape[0]

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.rows


def shard_graph(g: Graph, n_shards: int, row_mult: int = 8) -> ShardedGraph:
    n = g.n
    rows = _pow2_pad(max((n + n_shards - 1) // n_shards, 1), row_mult)
    n_pad = rows * n_shards
    src_h = g.edge_sources()
    owner = src_h // rows
    emax = int(np.bincount(owner, minlength=n_shards).max()) if len(src_h) else 1
    emax = _pow2_pad(max(emax, 1), 8)
    src = np.zeros((n_shards, emax), dtype=np.int32)
    dst = np.zeros((n_shards, emax), dtype=np.int32)
    w = np.zeros((n_shards, emax), dtype=np.float32)
    for s in range(n_shards):
        ids = np.flatnonzero(owner == s)
        src[s, :] = s * rows              # padding: own first row, w == 0
        dst[s, :] = s * rows
        src[s, :len(ids)] = src_h[ids]
        dst[s, :len(ids)] = g.adjncy[ids]
        w[s, :len(ids)] = g.adjwgt[ids]
    vw = np.zeros((n_shards, rows), dtype=np.float32)
    flat = np.zeros(n_pad, dtype=np.float32)
    flat[:n] = g.vwgt
    vw[:] = flat.reshape(n_shards, rows)
    return ShardedGraph(src, dst, w, vw, n, rows)


def _kway_round_local(src, dst, w, vwgt, labels, sizes_g, cap, noise,
                      parity: int, me: int, rows: int, k: int,
                      n_shards: int) -> torch.Tensor:
    """One shard's round: ``src``/``dst``/``w`` its (emax,) edges,
    ``vwgt`` the replicated (n_pad,) weights, ``labels`` the replicated
    (n_pad,) int32 labels, ``noise`` its (rows, k) draws.  Returns the new
    labels of its owned rows."""
    dev = labels.device
    off = me * rows
    lab_own = labels[off:off + rows]
    vw_own = vwgt[off:off + rows]
    tgt = labels[dst.long()].long()
    aff = torch.zeros(rows * k, dtype=torch.float32, device=dev).index_add_(
        0, (src.long() - off) * k + tgt, w).view(rows, k)
    lab = lab_own.long()[:, None]
    own = aff.gather(1, lab)[:, 0]
    gain = aff - own[:, None] + noise
    gain.scatter_(1, lab, _NEG)
    room = sizes_g[None, :] + vw_own[:, None] <= cap[None, :]
    gain = torch.where(room, gain, _NEG)
    best_gain = gain.amax(1)
    best_tgt = gain.argmax(1).to(lab_own.dtype)     # first maximum, as jnp
    gid = off + torch.arange(rows, device=dev)
    want = (best_gain > _GAIN_EPS) & ((gid + parity) % 2 == 0)
    proposal = torch.where(want, best_tgt, lab_own)
    # local capped acceptance against this shard's slice of global capacity
    cap_local = sizes_g + (cap - sizes_g) / n_shards
    return lp_mod.capped_accept(lab_own[None], proposal[None], vw_own,
                                sizes_g[None], cap_local,
                                torch.where(want, best_gain, _NEG)[None])[0]


def _parhip_refine(mesh: Mesh, src, dst, w, vwgt, labels0, cap,
                   noise: lp_mod.Noise, rows: int, k: int, rounds: int,
                   axis: str = "nodes") -> torch.Tensor:
    """The distributed k-way LP scan: ``rounds`` rounds of
    `_kway_round_local` on this rank's shard, each followed by the
    all-gather of the owned labels.  ``noise`` is a (rounds, rows, k)
    tensor or this rank's generator.  No host sync inside."""
    n_shards = mesh.extent(axis)
    me = mesh.axis_index(axis)
    dev = labels0.device
    noise = noise[None] if isinstance(noise, torch.Tensor) else [noise]
    labels = labels0
    for parity in range(rounds):
        sizes = torch.zeros(k, dtype=torch.float32, device=dev).index_add_(
            0, labels.long(), vwgt)
        nz = R._round_noise(noise, parity, rows, k, dev)[0]
        own = _kway_round_local(src, dst, w, vwgt, labels, sizes, cap, nz,
                                parity, me, rows, k, n_shards)
        labels = mesh.all_gather(own)
    return labels


def _nodes_mesh(mesh: Mesh, axis: str) -> int:
    if mesh.axis_names != (axis,):
        raise ValueError(f"parhip needs a 1-D ({axis!r},) mesh, got axes "
                         f"{mesh.axis_names}")
    return mesh.size


def parhip_refine(g: Graph, part: np.ndarray, k: int, eps: float,
                  mesh: Optional[Mesh] = None, rounds: int = 8,
                  seed: int = 0, axis: str = "nodes",
                  noise: Optional[torch.Tensor] = None,
                  device=None) -> np.ndarray:
    """Distributed k-way LP refinement (never applied blindly: keeps the
    better of in/out).  ``noise`` overrides this rank's draws with a
    (rounds, rows, k) tensor."""
    dev = device_of(mesh, device)
    mesh = mesh if mesh is not None else Mesh.local((axis,), dev)
    n_shards = _nodes_mesh(mesh, axis)
    rec = obs.current()
    sg = shard_graph(g, n_shards)
    me = mesh.axis_index(axis)
    labels0 = np.zeros(sg.n_pad, dtype=np.int32)
    labels0[:g.n] = part
    total = g.total_vwgt()
    cap = torch.full((k,), (1.0 + eps) * np.ceil(total / k),
                     dtype=torch.float32, device=dev)
    if noise is None:
        noise = torch.Generator(device=dev).manual_seed(R.row_seed(seed, me))
    else:
        noise = noise.to(dev)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    with rec.span("parhip_refine", n=g.n, rounds=rounds, shards=n_shards):
        out = _parhip_refine(mesh, put(sg.src[me]), put(sg.dst[me]),
                             put(sg.w[me]), put(sg.vwgt.reshape(-1)),
                             put(labels0), cap, noise, sg.rows, k, rounds,
                             axis)
        cand = out.cpu().numpy()[:g.n].astype(np.int64)
    rec.count("parhip/dist_rounds", rounds)
    rec.count("parhip/psum_rounds", rounds)   # one label all-gather/round
    if (edge_cut(g, cand) <= edge_cut(g, part)
            and is_feasible(g, cand, k, eps)):
        return cand
    rec.count("parhip/rounds_rejected")
    return part


PARHIP_PRESETS = {
    "ultrafastmesh":   dict(preset="fast", rounds=4),
    "fastmesh":        dict(preset="fast", rounds=8),
    "ecomesh":         dict(preset="eco", rounds=12),
    "ultrafastsocial": dict(preset="fastsocial", rounds=4),
    "fastsocial":      dict(preset="fastsocial", rounds=8),
    "ecosocial":       dict(preset="ecosocial", rounds=12),
}


def parhip(g: Graph, k: int, eps: float = 0.03,
           preconfiguration: str = "fastmesh", seed: int = 0,
           mesh: Optional[Mesh] = None,
           vertex_degree_weights: bool = False, report=None,
           device=None) -> np.ndarray:
    """The ``parhip`` program (§4.3.1) on ``mesh`` (None = a world of one
    on ``device``: None = CUDA, raising without a card unless
    ``device="cpu"``).

    Host-orchestrated multilevel with the distributed LP round as the
    refinement engine at every level; the coarsest graph is partitioned by
    the sequential tournament, as in the paper.  Every rank builds the
    same hierarchy and initial partition (the same seeds on the same
    device type); only the refinement rounds split the work.  ``report``
    is an optional ``obs.Recorder``.
    """
    dev = device_of(mesh, device)
    mesh = mesh if mesh is not None else Mesh.local(("nodes",), dev)
    _nodes_mesh(mesh, "nodes")
    if vertex_degree_weights:
        g = Graph(g.xadj, g.adjncy, 1 + g.degrees(), g.adjwgt)
    pc = PARHIP_PRESETS[preconfiguration]
    cfg = K.PRESETS[pc["preset"]]
    with obs.use(report):
        rec = obs.current()
        with rec.span("parhip", n=g.n, k=k,
                      preconfiguration=preconfiguration):
            levels = ML.build_hierarchy(K.GraphMedium(g, cfg, device=dev),
                                        k, seed)
            part = ML.initial_partition(levels[-1], k, eps, seed)

            def refine_level(medium: K.GraphMedium, part: np.ndarray,
                             li: int) -> np.ndarray:
                fine = medium.g
                part = parhip_refine(fine, part, k, eps, mesh,
                                     rounds=pc["rounds"], seed=seed + li)
                if not is_feasible(fine, part, k, eps):
                    coo, ell = medium.views
                    part = R.refine_kway(fine, part, k, eps, rounds=6,
                                         seed=seed + li, force_balance=True,
                                         coo=coo, ell=ell,
                                         use_kernel=medium.use_kernel)
                    rec.count("parhip/repairs")
                return part

            for li in range(len(levels) - 1, 0, -1):
                part = part[levels[li].cl]
                medium = levels[li - 1].medium
                with rec.span("parhip_level", level=li - 1, n=medium.n):
                    part = refine_level(medium, part, li)
                if rec.enabled:
                    rec.point("parhip", level=li - 1,
                              objective=float(edge_cut(medium.g, part)))
            if len(levels) == 1:
                # single-level hierarchy (n <= stop_n): the loop above is
                # empty — still run the distributed refiner and the
                # feasibility repair at level 0 instead of returning the raw
                # initial partition
                with rec.span("parhip_level", level=0, n=g.n):
                    part = refine_level(levels[0].medium, part, 0)
                if rec.enabled:
                    rec.point("parhip", level=0,
                              objective=float(edge_cut(g, part)))
    return part
