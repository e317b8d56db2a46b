"""Hypergraph containers — the dual-CSR layout KaHyPar-style partitioners use.

Host side: `Hypergraph` keeps BOTH incidence directions so every phase has
the traversal it needs without rebuilding:
  * vertex → incident nets:  ``vind`` (offsets) / ``vedges`` (net ids)
  * net    → pins:           ``eptr`` (offsets) / ``eind``  (vertex ids)
plus vertex weights ``vwgt`` and net weights ``ewgt``.  All irregular
preprocessing (IO, contraction bookkeeping, validation) happens here in
numpy, mirroring ``csr.Graph``.

Device side: two rectangular torch views on an explicit device:
  * `EllHypergraph` — padded ELL over BOTH sides: ``vnets`` (n_pad, dvmax)
    incident-net ids per vertex, and ``pins`` (e_pad, pmax) pin ids per net
    with a validity ``pin_mask``.  This is the layout the CUDA pin-count
    kernel (kernels/csrc/pin_count.cu) reads.
  * `PinCoo` — padded COO over pins for segment-op algorithms (the plain
    pin counts, gain computation, objectives).

Padding conventions (what `to_ell_h`/`to_pincoo` write, with the same pow2
buckets as the JAX package): ``e_pad > m`` always, so net row ``e_pad - 1``
is a genuine padding net (``netw == 0``) and serves as the ELL sentinel
for ``vnets``; padding pins carry ``pin_mask == 0`` / ``mask == 0`` and
point at vertex ``n_pad - 1``, contributing nothing to any reduction.  Only
the zero masks and weights mark padding: when n lands exactly on its
bucket, ``n_pad - 1`` is a real vertex.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.csr import (GraphFormatError, _as1d, _pow2_pad,
                                  resolve_device)


class HypergraphFormatError(GraphFormatError):
    """Raised by the hypergraph checker for malformed hypergraphs."""


@dataclasses.dataclass
class Hypergraph:
    """Host dual-CSR hypergraph."""

    vind: np.ndarray    # (n+1,) int64, offsets into vedges
    vedges: np.ndarray  # (p,)   int64, incident net ids per vertex
    eptr: np.ndarray    # (m+1,) int64, offsets into eind
    eind: np.ndarray    # (p,)   int64, pin vertex ids per net
    vwgt: np.ndarray    # (n,)   int64, vertex weights (>= 0)
    ewgt: np.ndarray    # (m,)   int64, net weights (> 0)

    def __post_init__(self):
        self.vind = _as1d(self.vind, np.int64)
        self.vedges = _as1d(self.vedges, np.int64)
        self.eptr = _as1d(self.eptr, np.int64)
        self.eind = _as1d(self.eind, np.int64)
        self.vwgt = _as1d(self.vwgt, np.int64)
        self.ewgt = _as1d(self.ewgt, np.int64)

    # -- basic accessors ---------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.vind) - 1

    @property
    def m(self) -> int:
        """Number of nets (hyperedges)."""
        return len(self.eptr) - 1

    @property
    def pins(self) -> int:
        return len(self.eind)

    def net_sizes(self) -> np.ndarray:
        return np.diff(self.eptr)

    def vertex_degrees(self) -> np.ndarray:
        return np.diff(self.vind)

    def net_pins(self, e: int) -> np.ndarray:
        return self.eind[self.eptr[e]:self.eptr[e + 1]]

    def incident_nets(self, v: int) -> np.ndarray:
        return self.vedges[self.vind[v]:self.vind[v + 1]]

    def total_vwgt(self) -> int:
        return int(self.vwgt.sum())

    def total_ewgt(self) -> int:
        return int(self.ewgt.sum())

    def pin_sources(self) -> np.ndarray:
        """Net id of each pin slot of ``eind`` (CSR row expansion)."""
        return np.repeat(np.arange(self.m, dtype=np.int64),
                         np.diff(self.eptr))

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_nets(n: int, nets: Sequence[Sequence[int]],
                  ewgt: Optional[Sequence[int]] = None,
                  vwgt: Optional[Sequence[int]] = None,
                  dedup_pins: bool = True) -> "Hypergraph":
        """Build from a list of pin lists; the vertex side is derived.

        Duplicate pins within a net are merged when ``dedup_pins`` (the
        hypergraph checker rejects them otherwise).
        """
        eptr = [0]
        eind: list = []
        for pins in nets:
            pins = np.asarray(pins, dtype=np.int64)
            if dedup_pins:
                pins = np.unique(pins)
            eind.extend(pins.tolist())
            eptr.append(len(eind))
        m = len(nets)
        ew = np.ones(m, dtype=np.int64) if ewgt is None \
            else _as1d(ewgt, np.int64)
        vw = np.ones(n, dtype=np.int64) if vwgt is None \
            else _as1d(vwgt, np.int64)
        eptr_a = np.asarray(eptr, dtype=np.int64)
        eind_a = np.asarray(eind, dtype=np.int64)
        vind, vedges = _dual_from_nets(n, eptr_a, eind_a)
        return Hypergraph(vind=vind, vedges=vedges, eptr=eptr_a,
                          eind=eind_a, vwgt=vw, ewgt=ew)

    @staticmethod
    def from_arrays(n: int, eptr, eind, ewgt=None, vwgt=None) -> "Hypergraph":
        """Build from the hMETIS-style (eptr, eind) arrays alone."""
        eptr = _as1d(eptr, np.int64)
        eind = _as1d(eind, np.int64)
        m = len(eptr) - 1
        ew = np.ones(m, dtype=np.int64) if ewgt is None \
            else _as1d(ewgt, np.int64)
        vw = np.ones(n, dtype=np.int64) if vwgt is None \
            else _as1d(vwgt, np.int64)
        vind, vedges = _dual_from_nets(n, eptr, eind)
        return Hypergraph(vind=vind, vedges=vedges, eptr=eptr, eind=eind,
                          vwgt=vw, ewgt=ew)

    @staticmethod
    def from_coactivation(counts: np.ndarray,
                          load: Optional[np.ndarray] = None,
                          sets: Optional[dict] = None,
                          min_weight: float = 0.5) -> "Hypergraph":
        """Snapshot constructor for observed-traffic hypergraphs
        (the JAX package's ``obs.live.TrafficAccumulator``).

        ``counts`` is an (n, n) co-activation weight matrix (only the
        strict upper triangle of ``counts`` is read — symmetrise first if
        both directions carry weight): every entry ≥ ``min_weight``
        becomes a 2-pin net with the rounded weight.  ``sets`` optionally
        maps pin tuples (KV co-access sets, cardinality ≥ 2) to weights,
        appended as genuine multi-pin nets.  ``load`` becomes the vertex
        weights (rounded, floored at 1) so (λ−1) partitioning balances
        observed item load while minimising replication traffic.
        """
        counts = np.asarray(counts, dtype=np.float64)
        n = counts.shape[0]
        u, v = np.triu_indices(n, 1)
        w = counts[u, v]
        keep = w >= min_weight
        u, v, w = u[keep], v[keep], np.rint(w[keep]).astype(np.int64)
        pins = np.empty(2 * len(u), dtype=np.int64)
        pins[0::2], pins[1::2] = u, v
        eptr = np.arange(0, 2 * len(u) + 1, 2, dtype=np.int64).tolist()
        eind = pins.tolist()
        ewgt = np.maximum(w, 1).tolist()
        if sets:
            for key in sorted(sets):
                sw = sets[key]
                if len(key) < 2 or sw < min_weight:
                    continue
                eind.extend(int(x) for x in key)
                eptr.append(len(eind))
                ewgt.append(max(int(round(sw)), 1))
        vwgt = None
        if load is not None:
            vwgt = np.maximum(np.rint(np.asarray(load)), 1).astype(np.int64)
        return Hypergraph.from_arrays(n, np.asarray(eptr, dtype=np.int64),
                                      np.asarray(eind, dtype=np.int64),
                                      ewgt=np.asarray(ewgt, dtype=np.int64),
                                      vwgt=vwgt)

    # -- checker -----------------------------------------------------------
    def check(self, raise_on_error: bool = True) -> list:
        """Validate all structural invariants (mirrors ``Graph.check``)."""
        errs = []
        n, m = self.n, self.m
        if self.eptr[0] != 0 or self.eptr[-1] != len(self.eind):
            errs.append("eptr endpoints inconsistent with eind length")
        if np.any(np.diff(self.eptr) < 0):
            errs.append("eptr not monotone")
        if self.vind[0] != 0 or self.vind[-1] != len(self.vedges):
            errs.append("vind endpoints inconsistent with vedges length")
        if np.any(np.diff(self.vind) < 0):
            errs.append("vind not monotone")
        if len(self.eind) and (self.eind.min() < 0 or self.eind.max() >= n):
            errs.append("pin vertex id out of range")
        if len(self.vedges) and (self.vedges.min() < 0
                                 or self.vedges.max() >= m):
            errs.append("incident net id out of range")
        if len(self.vwgt) != n:
            errs.append("vwgt length mismatch")
        if np.any(self.vwgt < 0):
            errs.append("negative vertex weight")
        if len(self.ewgt) != m:
            errs.append("ewgt length mismatch")
        if len(self.ewgt) and np.any(self.ewgt <= 0):
            errs.append("non-positive net weight")
        if not errs:
            pe = self.pin_sources()
            key = pe * np.int64(n) + self.eind
            skey = np.sort(key)
            if len(skey) > 1 and np.any(skey[1:] == skey[:-1]):
                errs.append("duplicate pin within a net")
            # dual consistency: (v, e) incidences must match on both sides
            pv = np.repeat(np.arange(n, dtype=np.int64),
                           np.diff(self.vind))
            vkey = self.vedges * np.int64(n) + pv
            if len(vkey) != len(key) or not np.array_equal(
                    np.sort(vkey), skey):
                errs.append("vertex-side and net-side incidences disagree")
        if errs and raise_on_error:
            raise HypergraphFormatError("; ".join(errs))
        return errs

    def is_unit_weighted(self) -> bool:
        return bool(np.all(self.vwgt == 1) and np.all(self.ewgt == 1))


def _dual_from_nets(n: int, eptr: np.ndarray, eind: np.ndarray):
    """Derive (vind, vedges) from (eptr, eind) by counting sort over pins."""
    if len(eind) and (eind.min() < 0 or eind.max() >= n):
        raise HypergraphFormatError("pin vertex id out of range")
    m = len(eptr) - 1
    pe = np.repeat(np.arange(m, dtype=np.int64), np.diff(eptr))
    order = np.argsort(eind * np.int64(max(m, 1)) + pe, kind="stable")
    vind = np.zeros(n + 1, dtype=np.int64)
    np.add.at(vind, eind + 1, 1)
    vind = np.cumsum(vind)
    return vind, pe[order]


# ---------------------------------------------------------------------------
# Device views
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EllHypergraph:
    """Padded ELL device hypergraph (both incidence directions).

    ``vnets`` padding slots point at net row ``e_pad - 1`` which always has
    ``netw == 0`` (``e_pad > m`` is guaranteed), so gathered scores vanish.
    ``pins`` padding slots carry ``pin_mask == 0``.
    """

    vnets: torch.Tensor     # (n_pad, dvmax) int32 — incident nets per vertex
    pins: torch.Tensor      # (e_pad, pmax)  int32 — pin ids per net
    pin_mask: torch.Tensor  # (e_pad, pmax)  f32   — 1 on real pins, 0 padding
    netw: torch.Tensor      # (e_pad,)       f32   — net weights, 0 padding
    vwgt: torch.Tensor      # (n_pad,)       f32   — vertex weights, 0 padding

    @property
    def n_pad(self) -> int:
        return self.vnets.shape[0]

    @property
    def e_pad(self) -> int:
        return self.pins.shape[0]

    @property
    def pmax(self) -> int:
        return self.pins.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pins.device


@dataclasses.dataclass
class PinCoo:
    """Padded pin list.  Padding pins are (net e_pad-1, vertex n_pad-1,
    mask 0) on a zero-weight net — invisible to every reduction.

    Indices are stored int32 like the kernel's and the JAX package's;
    ``pv_long``/``pe_long`` are the int64 copies torch's scatters need.
    """

    pv: torch.Tensor       # (p_pad,) int32 — pin's vertex
    pe: torch.Tensor       # (p_pad,) int32 — pin's net
    mask: torch.Tensor     # (p_pad,) f32   — 1 real, 0 padding
    netw: torch.Tensor     # (e_pad,) f32   — net weights, 0 padding
    esize: torch.Tensor    # (e_pad,) f32   — pin counts, 0 padding
    vwgt: torch.Tensor     # (n_pad,) f32   — vertex weights, 0 padding

    @property
    def p_pad(self) -> int:
        return self.pv.shape[0]

    @property
    def e_pad(self) -> int:
        return self.netw.shape[0]

    @property
    def n_pad(self) -> int:
        return self.vwgt.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vwgt.device

    @functools.cached_property
    def pv_long(self) -> torch.Tensor:
        return self.pv.long()

    @functools.cached_property
    def pe_long(self) -> torch.Tensor:
        return self.pe.long()


def _put(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(dev)


def to_ell_h(hg: Hypergraph, row_tile: int = 128, p_mult: int = 8,
             d_mult: int = 8, device=None) -> EllHypergraph:
    """Dual CSR → padded ELL views with pow2 shape bucketing, on
    ``device`` (None = CUDA).

    ``e_pad`` is padded past ``m`` so the last net row is always a padding
    net — the safe sentinel target for ``vnets`` padding slots.
    """
    dev = resolve_device(device)
    n, m = hg.n, hg.m
    n_pad = _pow2_pad(max(n, 1), row_tile)
    e_pad = _pow2_pad(m + 1, row_tile)
    # net → pins side
    esz = hg.net_sizes()
    pmax = int(esz.max()) if m else 0
    pmax = _pow2_pad(max(pmax, 1), p_mult)
    pins = np.full((e_pad, pmax), n_pad - 1, dtype=np.int32)
    mask = np.zeros((e_pad, pmax), dtype=np.float32)
    pe = hg.pin_sources()
    rank = np.arange(len(pe)) - hg.eptr[pe]
    pins[pe, rank] = hg.eind
    mask[pe, rank] = 1.0
    netw = np.zeros(e_pad, dtype=np.float32)
    netw[:m] = hg.ewgt
    # vertex → nets side
    deg = hg.vertex_degrees()
    dvmax = int(deg.max()) if n else 0
    dvmax = _pow2_pad(max(dvmax, 1), d_mult)
    vnets = np.full((n_pad, dvmax), e_pad - 1, dtype=np.int32)
    pv = np.repeat(np.arange(n, dtype=np.int64), deg)
    vrank = np.arange(len(pv)) - hg.vind[pv]
    vnets[pv, vrank] = hg.vedges
    vw = np.zeros(n_pad, dtype=np.float32)
    vw[:n] = hg.vwgt
    return EllHypergraph(vnets=_put(vnets, dev), pins=_put(pins, dev),
                         pin_mask=_put(mask, dev), netw=_put(netw, dev),
                         vwgt=_put(vw, dev))


def to_pincoo(hg: Hypergraph, p_mult: int = 256, n_mult: int = 128,
              e_mult: int = 128, device=None) -> PinCoo:
    """Dual CSR → padded pin COO with pow2 shape bucketing, on ``device``
    (None = CUDA)."""
    dev = resolve_device(device)
    n, m, p = hg.n, hg.m, hg.pins
    p_pad = _pow2_pad(max(p, 1), p_mult)
    n_pad = _pow2_pad(max(n, 1), n_mult)
    e_pad = _pow2_pad(m + 1, e_mult)
    pv = np.full(p_pad, n_pad - 1, dtype=np.int32)
    pe = np.full(p_pad, e_pad - 1, dtype=np.int32)
    mask = np.zeros(p_pad, dtype=np.float32)
    pv[:p] = hg.eind
    pe[:p] = hg.pin_sources()
    mask[:p] = 1.0
    netw = np.zeros(e_pad, dtype=np.float32)
    netw[:m] = hg.ewgt
    esize = np.zeros(e_pad, dtype=np.float32)
    esize[:m] = hg.net_sizes()
    vw = np.zeros(n_pad, dtype=np.float32)
    vw[:n] = hg.vwgt
    return PinCoo(pv=_put(pv, dev), pe=_put(pe, dev), mask=_put(mask, dev),
                  netw=_put(netw, dev), esize=_put(esize, dev),
                  vwgt=_put(vw, dev))
