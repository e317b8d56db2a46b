"""Graph containers.

Host side: `Graph` — the exact CSR layout of ``kaHIP_interface.h``
(xadj / adjncy / vwgt / adjwgt, forward+backward edge stored, vertices
0-indexed).  All irregular preprocessing (IO, contraction bookkeeping,
validation) happens here in numpy.

Device side: two rectangular torch views on an explicit device:
  * `EllGraph`  — padded ELL (n_pad, dmax) neighbour/weight matrices, the
    layout the CUDA affinity kernel (kernels/csrc/lp_affinity.cu) reads.
  * `CooGraph`  — padded directed edge list for segment-op algorithms
    (label propagation, gain computation).

Padding conventions (what `to_ell`/`to_coo` write): invalid ELL slots have
``nbr == n_pad - 1`` and ``wgt == 0``; invalid COO slots are the edge
``(n_pad - 1, n_pad - 1)`` with ``w == 0``; padding rows have vertex weight
0.  Only the zero weights mark padding: when n lands exactly on its bucket
the index ``n_pad - 1`` is a real vertex.

``coo_from_arrays``/``ell_from_arrays`` carry views given as numpy arrays
(for example the JAX package's views) over to this package's views
unchanged — a partitioner has no weights, so the graph and its views are
its whole state.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.obs.registry import metrics

#: Counter of `to_ell` calls: the host-built ELL views and their copies.
TO_ELL_BUILDS = "views/to_ell"


def resolve_device(device=None) -> torch.device:
    """The device rule of every entry point: ``None`` means ``"cuda"``.

    Asking for CUDA on a machine without it raises; nothing falls back to
    the CPU unless the caller passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class GraphFormatError(ValueError):
    """Raised by the graphchecker for malformed graphs."""


def _as1d(a, dtype):
    out = np.asarray(a, dtype=dtype)
    if out.ndim != 1:
        raise GraphFormatError(f"expected 1-d array, got shape {out.shape}")
    return out


@dataclasses.dataclass
class Graph:
    """Host CSR graph (undirected; both edge directions stored)."""

    xadj: np.ndarray    # (n+1,) int64, offsets into adjncy
    adjncy: np.ndarray  # (2m,)  int64, neighbour ids
    vwgt: np.ndarray    # (n,)   int64, node weights (>= 0)
    adjwgt: np.ndarray  # (2m,)  int64, edge weights (> 0), symmetric

    def __post_init__(self):
        self.xadj = _as1d(self.xadj, np.int64)
        self.adjncy = _as1d(self.adjncy, np.int64)
        self.vwgt = _as1d(self.vwgt, np.int64)
        self.adjwgt = _as1d(self.adjwgt, np.int64)

    # -- basic accessors ---------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.xadj) - 1

    @property
    def m(self) -> int:
        """Number of *undirected* edges."""
        return len(self.adjncy) // 2

    def degrees(self) -> np.ndarray:
        return np.diff(self.xadj)

    def neighbors(self, v: int) -> np.ndarray:
        return self.adjncy[self.xadj[v]:self.xadj[v + 1]]

    def edge_weights(self, v: int) -> np.ndarray:
        return self.adjwgt[self.xadj[v]:self.xadj[v + 1]]

    def total_vwgt(self) -> int:
        return int(self.vwgt.sum())

    def total_ewgt(self) -> int:
        return int(self.adjwgt.sum()) // 2

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_edges(n: int,
                   u: Sequence[int],
                   v: Sequence[int],
                   w: Optional[Sequence[int]] = None,
                   vwgt: Optional[Sequence[int]] = None,
                   dedup: bool = True) -> "Graph":
        """Build from an undirected edge list (each edge given once).

        Self loops are dropped; parallel edges are merged (weights summed)
        when ``dedup`` — matching what the KaHIP graphchecker would demand.
        """
        u = _as1d(u, np.int64)
        v = _as1d(v, np.int64)
        if w is None:
            w = np.ones_like(u)
        else:
            w = _as1d(w, np.int64)
        keep = u != v
        u, v, w = u[keep], v[keep], w[keep]
        # canonical order then dedup
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        if dedup and len(lo):
            key = lo * np.int64(n) + hi
            order = np.argsort(key, kind="stable")
            key, lo, hi, w = key[order], lo[order], hi[order], w[order]
            first = np.ones(len(key), dtype=bool)
            first[1:] = key[1:] != key[:-1]
            seg = np.cumsum(first) - 1
            wsum = np.zeros(int(seg[-1]) + 1 if len(seg) else 0, dtype=np.int64)
            np.add.at(wsum, seg, w)
            lo, hi, w = lo[first], hi[first], wsum
        # both directions
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        wgt = np.concatenate([w, w])
        order = np.argsort(src * np.int64(n) + dst, kind="stable")
        src, dst, wgt = src[order], dst[order], wgt[order]
        xadj = np.zeros(n + 1, dtype=np.int64)
        np.add.at(xadj, src + 1, 1)
        xadj = np.cumsum(xadj)
        vw = np.ones(n, dtype=np.int64) if vwgt is None else _as1d(vwgt, np.int64)
        return Graph(xadj=xadj, adjncy=dst, vwgt=vw, adjwgt=wgt)

    @staticmethod
    def from_arrays(xadj, adjncy, vwgt=None, adjwgt=None) -> "Graph":
        xadj = _as1d(xadj, np.int64)
        adjncy = _as1d(adjncy, np.int64)
        n = len(xadj) - 1
        if vwgt is None:
            vwgt = np.ones(n, dtype=np.int64)
        if adjwgt is None:
            adjwgt = np.ones(len(adjncy), dtype=np.int64)
        return Graph(xadj, adjncy, _as1d(vwgt, np.int64), _as1d(adjwgt, np.int64))

    # -- graphchecker --------------------------------------------------------
    def check(self, raise_on_error: bool = True) -> list:
        """The ``graphchecker`` tool: validates all invariants §3.3 lists."""
        errs = []
        n = self.n
        if self.xadj[0] != 0 or self.xadj[-1] != len(self.adjncy):
            errs.append("xadj endpoints inconsistent with adjncy length")
        if np.any(np.diff(self.xadj) < 0):
            errs.append("xadj not monotone")
        if len(self.adjncy) and (self.adjncy.min() < 0 or self.adjncy.max() >= n):
            errs.append("neighbour id out of range")
        if len(self.vwgt) != n:
            errs.append("vwgt length mismatch")
        if np.any(self.vwgt < 0):
            errs.append("negative vertex weight")
        if len(self.adjwgt) != len(self.adjncy):
            errs.append("adjwgt length mismatch")
        if len(self.adjwgt) and np.any(self.adjwgt <= 0):
            errs.append("non-positive edge weight")
        if not errs:
            src = np.repeat(np.arange(n, dtype=np.int64), np.diff(self.xadj))
            if np.any(src == self.adjncy):
                errs.append("self loop present")
            # parallel edges: duplicate (src, dst)
            key = src * np.int64(n) + self.adjncy
            skey = np.sort(key)
            if len(skey) > 1 and np.any(skey[1:] == skey[:-1]):
                errs.append("parallel edges present")
            # symmetry of edges and weights
            fwd = np.argsort(key, kind="stable")
            rkey = self.adjncy * np.int64(n) + src
            bwd = np.argsort(rkey, kind="stable")
            if not np.array_equal(key[fwd], rkey[bwd]):
                errs.append("missing backward edge")
            elif not np.array_equal(self.adjwgt[fwd], self.adjwgt[bwd]):
                errs.append("forward/backward edge weights differ")
        if errs and raise_on_error:
            raise GraphFormatError("; ".join(errs))
        return errs

    # -- derived graphs ------------------------------------------------------
    def with_edge_balanced_weights(self) -> "Graph":
        """--balance_edges: c'(v) = c(v) + deg_w(v) (paper §1)."""
        degw = np.zeros(self.n, dtype=np.int64)
        src = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.xadj))
        np.add.at(degw, src, self.adjwgt)
        return Graph(self.xadj, self.adjncy, self.vwgt + degw, self.adjwgt)

    def edge_sources(self) -> np.ndarray:
        return np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.xadj))

    def subgraph(self, mask: np.ndarray):
        """Induced subgraph on ``mask``; returns (subgraph, old_ids)."""
        ids = np.flatnonzero(mask)
        remap = -np.ones(self.n, dtype=np.int64)
        remap[ids] = np.arange(len(ids))
        src = self.edge_sources()
        keep = mask[src] & mask[self.adjncy]
        u, v, w = remap[src[keep]], remap[self.adjncy[keep]], self.adjwgt[keep]
        fwd = u < v  # each undirected edge once
        g = Graph.from_edges(len(ids), u[fwd], v[fwd], w[fwd],
                             vwgt=self.vwgt[ids], dedup=False)
        return g, ids


# ---------------------------------------------------------------------------
# Device views
# ---------------------------------------------------------------------------

def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _pow2_pad(x: int, mult: int) -> int:
    """Round up to a power-of-two multiple of ``mult`` (shape bucketing)."""
    x = max(x, mult)
    out = mult
    while out < x:
        out *= 2
    return out


@dataclasses.dataclass
class EllGraph:
    """Padded ELL device graph.

    Padding rows are isolated (vwgt 0); padding slots have nbr == n_pad-1
    and wgt == 0, so they contribute nothing to any reduction.
    """

    nbr: torch.Tensor    # (n_pad, dmax) int32
    wgt: torch.Tensor    # (n_pad, dmax) float32; 0 padding
    vwgt: torch.Tensor   # (n_pad,) float32; 0 padding

    @property
    def n_pad(self) -> int:
        return self.nbr.shape[0]

    @property
    def dmax(self) -> int:
        return self.nbr.shape[1]


@dataclasses.dataclass
class CooGraph:
    """Padded directed edge list.  Padding edges are (n_pad-1, n_pad-1, w=0)
    self-loops on a zero-weight row — invisible to every reduction.

    Indices are stored int32 like the kernel's and the JAX package's;
    ``src_long``/``dst_long`` are the int64 copies torch's scatters need.
    """

    src: torch.Tensor    # (e_pad,) int32
    dst: torch.Tensor    # (e_pad,) int32
    w: torch.Tensor      # (e_pad,) float32; 0 on padding
    vwgt: torch.Tensor   # (n_pad,) float32; 0 padding

    @property
    def e_pad(self) -> int:
        return self.src.shape[0]

    @property
    def n_pad(self) -> int:
        return self.vwgt.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vwgt.device

    @functools.cached_property
    def src_long(self) -> torch.Tensor:
        return self.src.long()

    @functools.cached_property
    def dst_long(self) -> torch.Tensor:
        return self.dst.long()


def ell_from_arrays(nbr, wgt, vwgt, device) -> EllGraph:
    """ELL view from host arrays (int32 nbr, float32 wgt/vwgt)."""
    dev = torch.device(device)
    return EllGraph(
        nbr=torch.tensor(np.asarray(nbr, np.int32), device=dev),
        wgt=torch.tensor(np.asarray(wgt, np.float32), device=dev),
        vwgt=torch.tensor(np.asarray(vwgt, np.float32), device=dev))


def coo_from_arrays(src, dst, w, vwgt, device) -> CooGraph:
    """COO view from host arrays (int32 src/dst, float32 w/vwgt)."""
    dev = torch.device(device)
    return CooGraph(
        src=torch.tensor(np.asarray(src, np.int32), device=dev),
        dst=torch.tensor(np.asarray(dst, np.int32), device=dev),
        w=torch.tensor(np.asarray(w, np.float32), device=dev),
        vwgt=torch.tensor(np.asarray(vwgt, np.float32), device=dev))


def to_ell(g: Graph, row_tile: int = 128, d_mult: int = 8,
           dmax_cap: Optional[int] = None, device=None) -> EllGraph:
    """CSR → padded ELL. ``dmax_cap`` truncates hub rows (heaviest edges kept).

    Built on the host and copied to ``device``; each call counts one
    ``TO_ELL_BUILDS``."""
    metrics.inc(TO_ELL_BUILDS)
    n = g.n
    deg = g.degrees()
    dmax = int(deg.max()) if n else 0
    if dmax_cap is not None:
        dmax = min(dmax, dmax_cap)
    dmax = _pow2_pad(max(dmax, 1), d_mult)
    n_pad = _pow2_pad(max(n, 1), row_tile)
    nbr = np.full((n_pad, dmax), n_pad - 1, dtype=np.int32)
    wgt = np.zeros((n_pad, dmax), dtype=np.float32)
    src = g.edge_sources()
    # rank of each edge within its row
    rank = np.arange(len(src)) - g.xadj[src]
    if dmax_cap is not None:
        # keep heaviest edges per row: sort by (row, -w) then recompute rank
        order = np.lexsort((-g.adjwgt, src))
        src_o, dst_o, w_o = src[order], g.adjncy[order], g.adjwgt[order]
        rank = np.arange(len(src_o)) - g.xadj[src_o]
        keep = rank < dmax
        nbr[src_o[keep], rank[keep]] = dst_o[keep]
        wgt[src_o[keep], rank[keep]] = w_o[keep]
    else:
        nbr[src, rank] = g.adjncy
        wgt[src, rank] = g.adjwgt
    vw = np.zeros(n_pad, dtype=np.float32)
    vw[:n] = g.vwgt
    return ell_from_arrays(nbr, wgt, vw, resolve_device(device))


def to_coo(g: Graph, e_mult: int = 256, n_mult: int = 256,
           device=None) -> CooGraph:
    """CSR → padded COO with pow2 shape bucketing."""
    n, e = g.n, len(g.adjncy)
    e_pad = _pow2_pad(max(e, 1), e_mult)
    n_pad = _pow2_pad(max(n, 1), n_mult)
    src = np.full(e_pad, n_pad - 1, dtype=np.int32)
    dst = np.full(e_pad, n_pad - 1, dtype=np.int32)
    w = np.zeros(e_pad, dtype=np.float32)
    src[:e] = g.edge_sources()
    dst[:e] = g.adjncy
    w[:e] = g.adjwgt
    vw = np.zeros(n_pad, dtype=np.float32)
    vw[:n] = g.vwgt
    return coo_from_arrays(src, dst, w, vw, resolve_device(device))
