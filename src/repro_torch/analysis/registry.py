"""Entry-point registry (port of ``repro/analysis/registry.py``): the
port's device programs, each with a canonical (tiny, deterministic)
instance the checkers run it on.

The host drivers in `core/interface.py` are orchestration loops; the
contracts live in the device programs they route through (the refinement
scans, the distributed rounds, the kernels' wrappers, the serve steps).
So the registry registers those programs, and `DRIVER_ENTRIES` maps every
public driver to the entries that cover it — the registry lint fails when
a public driver has no entry.

Every entry has the reference's name, plus four the reference lacks:
``kernels/pin_count_csr`` (``ops.pin_count_csr``, the kahypar scan's call
to kernel 2, whose padding is a masked pin list), ``engine/kway_lp_round``
(one k-way round on kernel 1's ELL route), ``dist/parhip_round`` (the
parhip scan, whose replication claim the spmd check holds) and
``fixture/*`` entries that the tests plant faults in.

``EntryPoint.build(device, mesh=None)`` returns ``(fn, args)`` with the
args on ``device``: a CPU run checks the plain paths, a CUDA run the
hand-written kernels (``use_kernel=None`` resolves by device, as on the
main path).  Entries tagged ``spmd`` take a ``mesh`` (None: a world of
one over ``mesh_axes``).  Port functions take their tie-break noise as an
argument, so the noise is one of the args: the padding perturbation
writes garbage into its padding slots too.

Each entry declares which checkers apply via ``tags`` and, for padded
containers, a `PaddingSpec`: a perturbation writing deterministic garbage
into padding slots only (the masking contract of ``kernels/ops.py``:
``PADDING_CONTRACT``) plus a projection selecting the *real* slots of
the outputs.  ``kernels`` names the launch counters a CUDA run must
raise; ``allow_syncs`` maps each host read the entry is allowed to make
(``file:function`` in the package) to the reason it is allowed;
``replicated`` picks the outputs the protocol claims every rank holds
alike.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

#: launch counters of the hand-written kernels (``kernels/*.LAUNCHES``)
LP_LAUNCHES = "kernels/lp_affinity/launches"
PIN_LAUNCHES = "kernels/pin_count/launches"
SSD_LAUNCHES = "kernels/ssd_scan/launches"
ATTN_LAUNCHES = "kernels/attention/launches"

NOISE = 1e-4        # lp._NOISE: the tie-break draws lie in [0, NOISE)
_DRAWS_SEED = 0xC0FFEE


@dataclasses.dataclass(frozen=True)
class PaddingSpec:
    """Noninterference spec: `perturb(args, rng)` returns args with garbage
    in padding slots only; `project(outputs)` keeps the real slots."""
    perturb: Callable[[Tuple, np.random.Generator], Tuple]
    project: Callable[[Any], Sequence]


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    name: str
    build: Callable[..., Tuple[Callable, Tuple]]  # (device, mesh) -> fn, args
    tags: frozenset                               # checkers that apply
    padding: Optional[PaddingSpec] = None
    kernels: Tuple[str, ...] = ()                 # launch counters on CUDA
    allow_syncs: Tuple[Tuple[str, str], ...] = ()  # (file:function, reason)
    replicated: Optional[Callable[[Any], Dict[str, Any]]] = None
    mesh_axes: Tuple[str, ...] = ()               # spmd: the mesh's axes
    drivers: Tuple[str, ...] = ()                 # interface.py publics

    def allowed(self, location: str) -> Optional[str]:
        """The reason ``location`` may sync, or None."""
        return dict(self.allow_syncs).get(location)


# ---------------------------------------------------------------------------
# canonical instances (host-side, deterministic)
# ---------------------------------------------------------------------------

def _ring_graph(n: int = 24, stride: int = 7):
    """Ring + chord graph: connected, irregular weights, tiny."""
    from repro_torch.core.csr import Graph
    nbrs = [[] for _ in range(n)]
    for i in range(n):
        for j in ((i + 1) % n, (i + stride) % n):
            nbrs[i].append(j)
            nbrs[j].append(i)
    xadj = np.zeros(n + 1, dtype=np.int64)
    adjncy, adjwgt = [], []
    for i in range(n):
        xadj[i + 1] = xadj[i] + len(nbrs[i])
        adjncy.extend(nbrs[i])
        adjwgt.extend(1 + ((i + j) % 3) for j in nbrs[i])
    return Graph.from_arrays(xadj, np.asarray(adjncy, np.int64),
                             vwgt=1 + np.arange(n) % 2,
                             adjwgt=np.asarray(adjwgt, np.int64))


def _tiny_hypergraph(n: int = 20, m: int = 12):
    from repro_torch.core.hypergraph.container import Hypergraph
    eptr = [0]
    eind = []
    for j in range(m):
        pins = {j % n, (j * 5 + 1) % n, (j * 3 + 7) % n, (j + n // 2) % n}
        eind.extend(sorted(pins))
        eptr.append(len(eind))
    return Hypergraph.from_arrays(
        n, np.asarray(eptr, np.int64), np.asarray(eind, np.int64),
        ewgt=1 + np.arange(m) % 2, vwgt=np.ones(n, np.int64))


RING_N, HG_N, HG_M = 24, 20, 12     # real vertices / nets of the instances


def _garble(idx: np.ndarray, where: np.ndarray, hi: int,
            rng: np.random.Generator, lo: int = 0) -> np.ndarray:
    """Copy of ``idx`` with slots selected by ``where`` replaced by random
    valid ids in [lo, hi) — the padding garbage injection."""
    out = np.array(idx)
    k = int(np.count_nonzero(where))
    if k:
        out[np.asarray(where)] = rng.integers(lo, hi, size=k,
                                              dtype=out.dtype)
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _like(a: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """``a`` as a tensor on ``t``'s device."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(t.device)


def _draws(shape) -> np.ndarray:
    """Deterministic tie-break draws in [0, NOISE), f32."""
    rng = np.random.default_rng(_DRAWS_SEED)
    return (rng.random(shape) * NOISE).astype(np.float32)


def _garble_noise(noise: torch.Tensor, pad: np.ndarray,
                  rng: np.random.Generator) -> torch.Tensor:
    """``noise`` with fresh draws in the slots ``pad`` (a boolean mask
    broadcast against it) selects."""
    a = _np(noise).copy()
    where = np.broadcast_to(pad, a.shape)
    a[where] = (rng.random(int(where.sum())) * NOISE).astype(np.float32)
    return _like(a, noise)


def _garble_rows(labels: torch.Tensor, lo_col: int, hi: int,
                 rng: np.random.Generator, lo: int = 0) -> torch.Tensor:
    """Labels (…, n_pad) with the padding columns from ``lo_col`` on set
    to random ids in [lo, hi)."""
    a = _np(labels).copy()
    a[..., lo_col:] = rng.integers(lo, hi, size=a[..., lo_col:].shape,
                                   dtype=a.dtype)
    return _like(a, labels)


def _put(a, dev, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, dtype=dtype))).to(dev)


def _use_kernel(dev) -> bool:
    from repro_torch.core.refine import default_use_kernel
    return default_use_kernel(dev)


# ---------------------------------------------------------------------------
# engine entries (graph / hypergraph / separator refinement, LP clustering)
# ---------------------------------------------------------------------------

KWAY_K, KWAY_ROUNDS, KWAY_B = 3, 4, 3


def _build_kway(use_kernel: bool, device, mesh=None):
    from repro_torch.core import refine as R
    from repro_torch.core.csr import to_coo, to_ell
    g = _ring_graph()
    coo = to_coo(g, device=device)
    k, rounds, b = KWAY_K, KWAY_ROUNDS, KWAY_B
    labs = np.zeros((b, coo.n_pad), np.int32)
    for i in range(b):
        labs[i, :g.n] = (np.arange(g.n) * (i + 1)) % k
    dev = coo.device
    args = (coo, _put(labs, dev), _put(R._caps_for(g, k, 0.10), dev,
                                       np.float32),
            _put(_draws((b, rounds, coo.n_pad, k)), dev),
            torch.full((b,), rounds, dtype=torch.int64, device=dev),
            torch.zeros(b, dtype=torch.bool, device=dev),
            torch.zeros(b, dtype=torch.bool, device=dev),
            torch.ones((b, coo.n_pad), dtype=torch.bool, device=dev))
    if not use_kernel:
        def fn(coo, labs, cap, noise, nr, z, f, a):
            return R._refine_scan_batch(coo, labs, cap, noise, nr, z, f, a,
                                        k, rounds)
        return fn, args

    def fnk(coo, labs, cap, noise, nr, z, f, a, ell):
        return R._refine_scan_batch(coo, labs, cap, noise, nr, z, f, a,
                                    k, rounds, ell=ell)
    return fnk, args + (to_ell(g, row_tile=coo.n_pad, device=dev),)


def _perturb_coo(coo, rng):
    """Garbage in CooGraph padding slots: w == 0 edges may point anywhere."""
    from repro_torch.core.csr import CooGraph
    pad = _np(coo.w) == 0
    n_pad = coo.n_pad
    return CooGraph(src=_like(_garble(_np(coo.src), pad, n_pad, rng), coo.src),
                    dst=_like(_garble(_np(coo.dst), pad, n_pad, rng), coo.dst),
                    w=coo.w, vwgt=coo.vwgt)


def _perturb_ell(ell, rng):
    from repro_torch.core.csr import EllGraph
    pad = _np(ell.wgt) == 0
    return EllGraph(nbr=_like(_garble(_np(ell.nbr), pad, ell.nbr.shape[0],
                                      rng), ell.nbr),
                    wgt=ell.wgt, vwgt=ell.vwgt)


def _perturb_kway(args, rng):
    coo, labs, noise = args[0], args[1], args[3]
    pad = np.zeros((1, 1, coo.n_pad, 1), bool)
    pad[:, :, RING_N:] = True
    out = (_perturb_coo(coo, rng), _garble_rows(labs, RING_N, KWAY_K, rng),
           args[2], _garble_noise(noise, pad, rng)) + tuple(args[4:8])
    if len(args) > 8:                      # the kernel variant's ELL
        out += (_perturb_ell(args[8], rng),)
    return out


def _project_kway(outs):
    labels, cuts = outs
    return [_np(labels)[:, :RING_N], _np(cuts)]


def _build_kway_round(device, mesh=None):
    """One k-way LP round with kernel 1's ELL affinities (the plain ELL
    version on the CPU)."""
    from repro_torch.core import lp as L
    from repro_torch.core.csr import to_coo, to_ell
    from repro_torch.core.refine import _caps_for
    from repro_torch.kernels import ops
    g = _ring_graph()
    coo = to_coo(g, device=device)
    dev = coo.device
    k, b = KWAY_K, 2
    labs = np.zeros((b, coo.n_pad), np.int32)
    for i in range(b):
        labs[i, :g.n] = (np.arange(g.n) * (i + 1)) % k
    vw = _np(coo.vwgt)
    sizes = np.stack([np.bincount(row, vw, minlength=k) for row in labs])
    cap = _caps_for(g, k, 0.10)

    def fn(coo, labs, sizes, cap, noise, ell):
        return L.kway_lp_round(
            coo, labs, sizes, cap, noise, k, 1, None,
            torch.zeros(b, dtype=torch.bool, device=dev),
            torch.zeros(b, dtype=torch.bool, device=dev),
            affinity_fn=lambda _g, lab, kk: ops.lp_affinity(
                ell.nbr, ell.wgt, lab, kk))
    return fn, (coo, _put(labs, dev), _put(sizes, dev, np.float32),
                _put(cap, dev, np.float32),
                _put(_draws((b, coo.n_pad, k)), dev),
                to_ell(g, row_tile=coo.n_pad, device=dev))


def _perturb_kway_round(args, rng):
    coo, labs, sizes, cap, noise, ell = args
    pad = np.zeros((1, coo.n_pad, 1), bool)
    pad[:, RING_N:] = True
    return (_perturb_coo(coo, rng), _garble_rows(labs, RING_N, KWAY_K, rng),
            sizes, cap, _garble_noise(noise, pad, rng),
            _perturb_ell(ell, rng))


def _build_cluster_lp(device, mesh=None):
    from repro_torch.core import lp as L
    from repro_torch.core.csr import to_coo
    g = _ring_graph()
    coo = to_coo(g, device=device)
    dev = coo.device
    iters = 4
    cap = torch.full((coo.n_pad,), 6.0 * g.n, device=dev)
    labs = torch.arange(coo.n_pad, dtype=torch.int32, device=dev)

    def fn(coo, labs, cap, noise):
        return L.cluster_lp(coo, labs, cap, noise, iters)
    return fn, (coo, labs, cap, _put(_draws((iters, coo.e_pad)), dev))


def _perturb_cluster_lp(args, rng):
    coo, labs, cap, noise = args
    # padding vertices (vwgt 0) may start in any singleton cluster; the
    # draws of padding edges (w == 0) may be anything
    return (_perturb_coo(coo, rng),
            _garble_rows(labs, RING_N, coo.n_pad, rng, lo=RING_N), cap,
            _garble_noise(noise, (_np(coo.w) == 0)[None], rng))


HYPER_K, HYPER_ROUNDS, HYPER_B = 3, 4, 2


def _build_hyper(objective: str, device, mesh=None):
    from repro_torch.core.hypergraph import refine as HR
    from repro_torch.core.hypergraph.container import to_pincoo
    hg = _tiny_hypergraph()
    hc = to_pincoo(hg, device=device)
    dev = hc.device
    k, rounds, b = HYPER_K, HYPER_ROUNDS, HYPER_B
    k_pad = HR.k_bucket(k)
    labs = np.zeros((b, hc.n_pad), np.int32)
    for i in range(b):
        labs[i, :hg.n] = (np.arange(hg.n) + i) % k
    cap = HR._pad_caps(HR._caps_for(hg, k, 0.10), k_pad)
    use_kernel = _use_kernel(dev)

    def fn(hc, labs, cap, noise, force):
        return HR._hyper_refine_scan_batch(hc, labs, cap, noise, force,
                                           k_pad, rounds, objective,
                                           use_kernel)
    return fn, (hc, _put(labs, dev), _put(cap, dev, np.float32),
                _put(_draws((b, rounds, hc.n_pad, k_pad)), dev),
                torch.zeros(b, dtype=torch.bool, device=dev))


def _perturb_pincoo(hc, rng):
    """Garbage in PinCoo padding pins (mask 0): any vertex, any net."""
    pad = _np(hc.mask) == 0
    return dataclasses.replace(
        hc, pv=_like(_garble(_np(hc.pv), pad, hc.n_pad, rng), hc.pv),
        pe=_like(_garble(_np(hc.pe), pad, hc.e_pad, rng), hc.pe))


def _perturb_hyper(args, rng):
    hc, labs, cap, noise, force = args
    k = HYPER_K
    # padding vertices' draws, and every vertex's draws for the
    # bucket-padding blocks (capacity 0: never a target)
    pad = np.zeros((1, 1, hc.n_pad, noise.shape[-1]), bool)
    pad[:, :, HG_N:] = True
    pad[..., k:] = True
    return (_perturb_pincoo(hc, rng), _garble_rows(labs, HG_N, k, rng), cap,
            _garble_noise(noise, pad, rng), force)


def _project_hyper(outs):
    return [_np(outs[0])[:, :HG_N], _np(outs[1])]


SEP_ROUNDS, SEP_B = 4, 2


def _build_sep(device, mesh=None):
    from repro_torch.core.csr import to_coo, to_ell
    from repro_torch.core.nodesep import refine as SR
    g = _ring_graph()
    coo = to_coo(g, device=device)
    dev = coo.device
    rounds, b = SEP_ROUNDS, SEP_B
    labs = np.full((b, coo.n_pad), 2, np.int32)     # everything separator
    labs[:, :g.n] = np.arange(g.n)[None, :] % 2
    labs[0, : g.n // 2] = 2
    ell = (to_ell(g, row_tile=coo.n_pad, device=dev) if _use_kernel(dev)
           else None)

    def fn(coo, labs, cap, noise, force, ell):
        return SR._sep_refine_scan_batch(coo, labs, cap, noise, force,
                                         rounds, ell=ell)
    return fn, (coo, _put(labs, dev),
                _put(SR.separator_caps(g, 0.20), dev, np.float32),
                _put(_draws((b, rounds, coo.n_pad)), dev),
                torch.zeros(b, dtype=torch.bool, device=dev), ell)


def _perturb_sep(args, rng):
    coo, labs, cap, noise, force, ell = args
    pad = np.zeros((1, 1, coo.n_pad), bool)
    pad[..., RING_N:] = True
    return (_perturb_coo(coo, rng), _garble_rows(labs, RING_N, 3, rng), cap,
            _garble_noise(noise, pad, rng), force,
            None if ell is None else _perturb_ell(ell, rng))


def _project_sep(outs):
    return [_np(outs[0])[:, :RING_N], _np(outs[1])]


# ---------------------------------------------------------------------------
# distributed / memetic entries (a mesh of one unless the caller gives one)
# ---------------------------------------------------------------------------

DIST_K, DIST_ROUNDS = 3, 4


def _mesh(mesh, axes, dev):
    from repro_torch.core.mesh import Mesh
    return mesh if mesh is not None else Mesh.local(axes, dev)


def _shard_level(mesh, dev):
    """This rank's shard of the tiny hypergraph on ``mesh`` (``nets`` or
    ``(nets, verts)``), as device tensors."""
    from repro_torch.core.hypergraph import dist as D
    hg = _tiny_hypergraph()
    sh = D.shard_hypergraph(hg, D._mesh_extents(mesh))
    lay = D._layout(mesh, sh)
    L = D._level0(lay, sh, dev)
    return hg, sh, lay, (L.pv, L.pe, L.mask, L.eptr, L.netw, L.esize,
                         L.vwgt)


def _build_parhyp(axes, device, mesh=None):
    from repro_torch.core.hypergraph import dist as D
    from repro_torch.core.hypergraph.refine import (_caps_for, _pad_caps,
                                                    k_bucket)
    from repro_torch.core.mesh import device_of
    mesh = _mesh(mesh, axes, device)
    dev = device_of(mesh)
    hg, sh, lay, level = _shard_level(mesh, dev)
    k, rounds = DIST_K, DIST_ROUNDS
    k_pad = k_bucket(k)
    labels0 = np.zeros(sh.n_pad, np.int32)
    labels0[:hg.n] = np.arange(hg.n) % k
    use_kernel = _use_kernel(dev)

    def fn(pv, pe, mask, eptr, netw, esize, vwgt, labels0, cap, noise):
        L = D._DeviceLevel(pv, pe, mask, eptr, netw, esize, vwgt)
        return D._parhyp_refine(lay, L, labels0, cap, noise[None], False,
                                k_pad, rounds, "km1", use_kernel)
    return fn, level + (_put(labels0, dev),
                        _put(_pad_caps(_caps_for(hg, k, 0.10), k_pad), dev,
                             np.float32),
                        _put(_draws((rounds, sh.n_pad, k_pad)), dev))


def _perturb_pins(args, rng):
    """Garbage in a shard's padding pins (mask 0): any vertex, any net."""
    pv, pe, mask = args[:3]
    n_pad, e_pad = args[6].shape[0], args[4].shape[0]
    pad = _np(mask) == 0
    return (_like(_garble(_np(pv), pad, n_pad, rng), pv),
            _like(_garble(_np(pe), pad, e_pad, rng), pe), mask)


def _perturb_parhyp(args, rng):
    noise = args[9]
    pad = np.zeros((1, noise.shape[1], noise.shape[2]), bool)
    pad[:, HG_N:] = True
    pad[..., DIST_K:] = True
    return (_perturb_pins(args, rng) + tuple(args[3:7])
            + (_garble_rows(args[7], HG_N, DIST_K, rng), args[8],
               _garble_noise(noise, pad, rng)))


def _project_parhyp(outs):
    return [_np(outs[0])[:HG_N], _np(outs[1]), _np(outs[2])]


def _replicated_all(outs):
    """Every output of the entry: the protocol replicates them all."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    return {f"out[{i}]": o for i, o in enumerate(outs)}


def _build_parhyp_cluster(device, mesh=None):
    from repro_torch.core.hypergraph import dist as D
    mesh = _mesh(mesh, ("nets",), device)
    hg, sh, lay, level = _shard_level(mesh, mesh.device)
    dev = mesh.device

    def fn(pv, pe, mask, eptr, netw, esize, vwgt, labels0, capv):
        L = D._DeviceLevel(pv, pe, mask, eptr, netw, esize, vwgt)
        return D._parhyp_cluster(lay, L, labels0, capv, 0, 4)
    return fn, level + (torch.arange(sh.n_pad, dtype=torch.int32,
                                     device=dev),
                        torch.full((sh.n_pad,), 8.0, device=dev))


def _perturb_parhyp_cluster(args, rng):
    # padding vertices (vwgt 0) may start in any singleton cluster
    n_pad = args[6].shape[0]
    return (_perturb_pins(args, rng) + tuple(args[3:7])
            + (_garble_rows(args[7], HG_N, n_pad, rng, lo=HG_N), args[8]))


def _build_parhyp_contract(device, mesh=None):
    from repro_torch.core.hypergraph import dist as D
    mesh = _mesh(mesh, ("nets",), device)
    hg, sh, lay, level = _shard_level(mesh, mesh.device)
    labels = (np.arange(sh.n_pad, dtype=np.int32) // 2) * 2

    def fn(pv, pe, mask, eptr, netw, esize, vwgt, labels):
        L = D._DeviceLevel(pv, pe, mask, eptr, netw, esize, vwgt)
        lvl, coarse_of, nc, hi = D._contract(lay, L, labels)
        return (lvl.pv, lvl.pe, lvl.mask, lvl.eptr, lvl.netw, lvl.esize,
                lvl.vwgt, coarse_of, nc, hi)
    return fn, level + (_put(labels, mesh.device),)


def _perturb_parhyp_contract(args, rng):
    n_pad = args[6].shape[0]
    return (_perturb_pins(args, rng) + tuple(args[3:7])
            + (_garble_rows(args[7], HG_N, n_pad, rng, lo=HG_N),))


def _project_parhyp_contract(outs):
    # coarse_of of padding vertices depends on their (free) input labels;
    # every other output is fully determined by the real slots
    outs = [_np(o) for o in outs]
    outs[7] = outs[7][:HG_N]
    return outs


def _replicated_contract(outs):
    # the coarse pin list is the rank's own shard; the net vectors, the
    # coarse vertex weights, the id map and both scalars are replicated
    names = ("netw", "esize", "vwgt", "coarse_of", "nc", "hi")
    return dict(zip(names, outs[4:]))


PARHIP_K, PARHIP_ROUNDS = 3, 4


def _build_parhip(device, mesh=None):
    from repro_torch.core import parhip as P
    from repro_torch.core.refine import _caps_for
    mesh = _mesh(mesh, ("nodes",), device)
    dev = mesh.device
    g = _ring_graph()
    sg = P.shard_graph(g, mesh.size)
    me = mesh.axis_index("nodes")
    k, rounds = PARHIP_K, PARHIP_ROUNDS
    labels0 = np.zeros(sg.n_pad, np.int32)
    labels0[:g.n] = np.arange(g.n) % k
    # each rank's draws for its rows: the slice of one full-width draw
    noise = _draws((rounds, sg.n_pad, k))[:, me * sg.rows:(me + 1) * sg.rows]

    def fn(src, dst, w, vwgt, labels0, cap, noise):
        return P._parhip_refine(mesh, src, dst, w, vwgt, labels0, cap,
                                noise, sg.rows, k, rounds)
    return fn, (_put(sg.src[me], dev), _put(sg.dst[me], dev),
                _put(sg.w[me], dev), _put(sg.vwgt.reshape(-1), dev),
                _put(labels0, dev),
                _put(_caps_for(g, k, 0.10), dev, np.float32),
                _put(noise, dev))


def _perturb_parhip(args, rng):
    src, dst, w, vwgt, labels0, cap, noise = args
    pad = _np(w) == 0
    rows = noise.shape[1]
    off = int(_np(src)[0]) // rows * rows       # this shard's first row
    npad = np.zeros((1, rows, 1), bool)
    npad[:, max(RING_N - off, 0):] = True
    return (_like(_garble(_np(src), pad, off + rows, rng, lo=off), src),
            _like(_garble(_np(dst), pad, vwgt.shape[0], rng), dst), w, vwgt,
            _garble_rows(labels0, RING_N, PARHIP_K, rng), cap,
            _garble_noise(noise, npad, rng))


def _build_migrate(device, mesh=None):
    from repro_torch.core.memetic import migrate as MG
    mesh = _mesh(mesh, (MG.AXIS,), device)
    parts = np.arange(2 * mesh.size * 32, dtype=np.int32).reshape(-1, 32)

    def fn(parts):
        return MG._ring_roll_mesh(MG.islands_mesh(mesh), parts, 3)
    return fn, (parts,)


# ---------------------------------------------------------------------------
# kernel entries (the public wrappers of kernels/ops.py)
# ---------------------------------------------------------------------------

def _labels(n_pad: int, k: int, b: int = 2) -> np.ndarray:
    return ((np.arange(n_pad)[None, :] + np.arange(b)[:, None]) % k
            ).astype(np.int32)


def _build_lp_affinity(device, mesh=None):
    from repro_torch.core.csr import to_ell
    from repro_torch.kernels import ops
    ell = to_ell(_ring_graph(), device=device)

    def fn(nbr, wgt, labels):
        return ops.lp_affinity(nbr, wgt, labels, 4)
    return fn, (ell.nbr, ell.wgt, _put(_labels(ell.n_pad, 4), ell.nbr.device))


def _perturb_ell_args(k):
    def perturb(args, rng):
        nbr, wgt = args[0], args[1]
        nbr2 = _garble(_np(nbr), _np(wgt) == 0, nbr.shape[0], rng)
        return ((_like(nbr2, nbr),) + tuple(args[1:-1])
                + (_garble_rows(args[-1], RING_N, k, rng),))
    return perturb


def _build_sep_affinity(device, mesh=None):
    from repro_torch.core.csr import to_ell
    from repro_torch.kernels import ops
    ell = to_ell(_ring_graph(), device=device)

    def fn(nbr, wgt, vwgt, labels):
        return ops.sep_affinity(nbr, wgt, vwgt, labels)
    return fn, (ell.nbr, ell.wgt, ell.vwgt,
                _put(_labels(ell.n_pad, 3), ell.nbr.device))


def _build_pin_count(device, mesh=None):
    from repro_torch.core.hypergraph.container import to_ell_h
    from repro_torch.kernels import ops
    eh = to_ell_h(_tiny_hypergraph(), device=device)

    def fn(pins, pin_mask, netw, labels):
        return ops.pin_count(pins, pin_mask, netw, labels, 4)
    return fn, (eh.pins, eh.pin_mask, eh.netw,
                _put(_labels(eh.n_pad, 4), eh.device))


def _perturb_pin_count(args, rng):
    pins, mask, netw, labels = args
    n_pad = labels.shape[-1]
    return (_like(_garble(_np(pins), _np(mask) == 0, n_pad, rng), pins),
            mask, netw, _garble_rows(labels, HG_N, 4, rng))


def _build_pin_count_csr(device, mesh=None):
    from repro_torch.core.hypergraph.container import to_pincoo
    from repro_torch.kernels import ops
    hc = to_pincoo(_tiny_hypergraph(), device=device)

    def fn(eptr, pv, mask, labels):
        return ops.pin_count_csr(eptr, pv, mask, labels, 4)
    return fn, (hc.eptr, hc.pv, hc.mask, _put(_labels(hc.n_pad, 4),
                                              hc.device))


def _perturb_pin_count_csr(args, rng):
    eptr, pv, mask, labels = args
    n_pad = labels.shape[-1]
    pad = _np(mask) == 0
    # pins past eptr[-1] lie in no net: their weights may be anything too
    past = np.arange(pv.shape[0]) >= int(_np(eptr)[-1])
    m = _np(mask).copy()
    m[past] = rng.integers(0, 3, size=int(past.sum())).astype(np.float32)
    return (eptr, _like(_garble(_np(pv), pad, n_pad, rng), pv),
            _like(m, mask), _garble_rows(labels, HG_N, 4, rng))


def _build_pin_affinity(device, mesh=None):
    from repro_torch.core.hypergraph.container import to_ell_h
    from repro_torch.kernels import ops
    eh = to_ell_h(_tiny_hypergraph(), device=device)

    def fn(vnets, pins, pin_mask, netw, labels):
        return ops.pin_affinity(vnets, pins, pin_mask, netw, labels, 4)
    return fn, (eh.vnets, eh.pins, eh.pin_mask, eh.netw,
                _put(_labels(eh.n_pad, 4), eh.device))


def _perturb_pin_affinity(args, rng):
    vnets, pins, mask, netw, labels = args
    n_pad = labels.shape[-1]
    pins2 = _garble(_np(pins), _np(mask) == 0, n_pad, rng)
    # vnets padding slots point at *a* zero-weight net (contract); move
    # them to a random other zero-weight net
    zero_nets = np.flatnonzero(_np(netw) == 0)
    vn = _np(vnets).copy()
    pad = np.isin(vn, zero_nets)
    vn[pad] = rng.choice(zero_nets, size=int(pad.sum()))
    return (_like(vn, vnets), _like(pins2, pins), mask, netw,
            _garble_rows(labels, HG_N, 4, rng))


def _build_ssd(device, mesh=None):
    from repro_torch.core.csr import resolve_device
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    bh, l, p, n = 2, 128, 4, 4
    x = rng.standard_normal((bh, l, p)).astype(np.float32)
    ld = -np.abs(rng.standard_normal((bh, l)).astype(np.float32))
    b = rng.standard_normal((bh, l, n)).astype(np.float32)
    c = rng.standard_normal((bh, l, n)).astype(np.float32)

    def fn(x, ld, b, c):
        return ops.ssd_scan(x, ld, b, c, chunk=64)
    return fn, tuple(_put(a, dev) for a in (x, ld, b, c))


def _build_attention(device, mesh=None):
    from repro_torch.core.csr import resolve_device
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 80, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 96, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 96, 2, 64)).astype(np.float32)

    def fn(q, k, v):
        return ops.attention_fwd(q, k, v, scale=0.125, q_offset=16)
    return fn, tuple(_put(a, dev) for a in (q, k, v))


# ---------------------------------------------------------------------------
# serve entries
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _serve_model(arch: str, device: str):
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    return cfg, T.init_params(cfg, 0, device=device)


def _serve_setup(arch: str, slots: int, device):
    from repro_torch.core.csr import resolve_device
    from repro_torch.models import transformer as T
    dev = resolve_device(device)
    cfg, model = _serve_model(arch, str(dev))
    return cfg, model, T.init_caches(cfg, slots, 16, device=dev), dev


def _build_prefill_step1(device, mesh=None):
    from repro_torch.serve.serve_step import prefill_step
    cfg, model, caches, dev = _serve_setup("minicpm_2b", 1, device)

    def fn(tok, caches):
        # the batcher's prefill: one token per step (stepwise=True)
        return prefill_step(model, cfg, tok, caches, stepwise=True)[0]
    return fn, (torch.ones((1, 1), dtype=torch.int64, device=dev), caches)


def _build_decode_slots(device, mesh=None):
    from repro_torch.serve.serve_step import decode_step
    cfg, model, caches, dev = _serve_setup("minicpm_2b", 2, device)

    def fn(toks, pos, caches):
        # the batched decode: every slot at its own cursor
        return decode_step(model, cfg, toks, caches, pos)[0]
    return fn, (torch.zeros((2, 1), dtype=torch.int64, device=dev),
                torch.tensor([0, 3], device=dev), caches)


def _build_moe_gate_tap(device, mesh=None):
    from repro_torch.models import moe
    from repro_torch.serve.serve_step import decode_step
    cfg, model, caches, dev = _serve_setup("deepseek_v2_236b", 1, device)

    def fn(toks, caches):
        # the allowed observability tap: observe_gates copies every MoE
        # call's routed expert ids to the host
        with moe.observe_gates(lambda *_: None):
            return decode_step(model, cfg, toks, caches, 0)[0]
    return fn, (torch.zeros((1, 1), dtype=torch.int64, device=dev), caches)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

_T = frozenset

#: host reads the engine entries make by design, with their reasons
_ROUND_BOUND = ("one read of nrounds.max() per call bounds the Python "
                "round loop (rounds past every row's count are not run); "
                "no read inside a round")
_OFFSETS = ("the pin list's offsets are validated on the host once per "
            "tensor and version (kernels/pin_affinity.check_offsets): a "
            "scan passes one level's offsets to every round")
_CSR_PLAIN = ("the plain CSR version reads the largest net size and its "
              "per-rank live counts to loop over pin ranks; it runs only "
              "on CPU tensors, where the read is no device sync")
_RING_HOST = ("the ring's result is the host (I, n) matrix every caller "
              "reads: one copy per migration")
_GATE_TAP = ("observe_gates: one copy of the routed expert ids to the host "
             "per MoE call, opt-in observability for the traffic "
             "hypergraph (obs.live.TrafficAccumulator)")
_CSR_SYNCS = (("kernels/pin_affinity.py:check_offsets", _OFFSETS),
              ("kernels/ref.py:pin_count_csr_ref", _CSR_PLAIN))

ENTRIES: Tuple[EntryPoint, ...] = (
    EntryPoint(
        name="engine/kway_refine",
        build=functools.partial(_build_kway, False),
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_kway, _project_kway),
        allow_syncs=(("core/refine.py:_refine_scan_batch", _ROUND_BOUND),),
        drivers=("kaffpa", "kaffpa_balance_NE", "kaffpaE", "reduced_nd",
                 "fast_reduced_nd", "process_mapping"),
    ),
    EntryPoint(
        name="engine/kway_refine_kernel",
        build=functools.partial(_build_kway, True),
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_kway, _project_kway),
        kernels=(LP_LAUNCHES,),
        allow_syncs=(("core/refine.py:_refine_scan_batch", _ROUND_BOUND),),
        drivers=("kaffpa",),
    ),
    EntryPoint(
        name="engine/kway_lp_round",
        build=_build_kway_round,
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_kway_round,
                            lambda outs: [_np(outs[0])[:, :RING_N],
                                          _np(outs[1])]),
        kernels=(LP_LAUNCHES,),
        drivers=("kaffpa",),
    ),
    EntryPoint(
        name="engine/cluster_lp",
        build=_build_cluster_lp,
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_cluster_lp,
                            lambda outs: [_np(outs)[:RING_N]]),
        drivers=("kaffpa", "kahypar", "node_separator"),
    ),
    EntryPoint(
        name="engine/hyper_refine_km1",
        build=functools.partial(_build_hyper, "km1"),
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_hyper, _project_hyper),
        kernels=(PIN_LAUNCHES,),
        allow_syncs=(("core/hypergraph/refine.py:_hyper_refine_scan_batch",
                      _ROUND_BOUND),) + _CSR_SYNCS,
        drivers=("kahypar", "kahyparE"),
    ),
    EntryPoint(
        name="engine/hyper_refine_cut",
        build=functools.partial(_build_hyper, "cut"),
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_hyper, _project_hyper),
        kernels=(PIN_LAUNCHES,),
        allow_syncs=(("core/hypergraph/refine.py:_hyper_refine_scan_batch",
                      _ROUND_BOUND),) + _CSR_SYNCS,
        drivers=("kahypar", "kahyparE"),
    ),
    EntryPoint(
        name="engine/sep_refine",
        build=_build_sep,
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_sep, _project_sep),
        kernels=(LP_LAUNCHES,),
        drivers=("node_separator", "reduced_nd", "fast_reduced_nd"),
    ),
    EntryPoint(
        name="dist/parhip_round",
        build=_build_parhip,
        tags=_T({"padding", "spmd", "hygiene"}),
        padding=PaddingSpec(_perturb_parhip,
                            lambda outs: [_np(outs)[:RING_N]]),
        replicated=_replicated_all,
        mesh_axes=("nodes",),
    ),
    EntryPoint(
        name="dist/parhyp_round",
        build=functools.partial(_build_parhyp, ("nets",)),
        tags=_T({"padding", "spmd", "hygiene"}),
        padding=PaddingSpec(_perturb_parhyp, _project_parhyp),
        kernels=(PIN_LAUNCHES,),
        allow_syncs=_CSR_SYNCS,
        replicated=_replicated_all,
        mesh_axes=("nets",),
        drivers=("parhyp",),
    ),
    EntryPoint(
        name="dist/parhyp_round_2d",
        build=functools.partial(_build_parhyp, ("nets", "verts")),
        tags=_T({"padding", "spmd", "hygiene"}),
        padding=PaddingSpec(_perturb_parhyp, _project_parhyp),
        kernels=(PIN_LAUNCHES,),
        allow_syncs=_CSR_SYNCS,
        replicated=_replicated_all,
        mesh_axes=("nets", "verts"),
        drivers=("parhyp",),
    ),
    EntryPoint(
        name="dist/cluster_round",
        build=_build_parhyp_cluster,
        tags=_T({"padding", "spmd", "hygiene"}),
        padding=PaddingSpec(_perturb_parhyp_cluster,
                            lambda outs: [_np(outs)[:HG_N]]),
        replicated=_replicated_all,
        mesh_axes=("nets",),
        drivers=("parhyp",),
    ),
    EntryPoint(
        name="dist/contract",
        build=_build_parhyp_contract,
        tags=_T({"padding", "spmd", "hygiene"}),
        padding=PaddingSpec(_perturb_parhyp_contract,
                            _project_parhyp_contract),
        replicated=_replicated_contract,
        mesh_axes=("nets",),
        drivers=("parhyp",),
    ),
    EntryPoint(
        name="memetic/migrate_ring",
        build=_build_migrate,
        tags=_T({"spmd", "hygiene"}),
        allow_syncs=(("core/memetic/migrate.py:_ring_roll_mesh",
                      _RING_HOST),),
        replicated=lambda outs: {"parts": outs},
        mesh_axes=("islands",),
        drivers=("kaffpaE", "kahyparE"),
    ),
    EntryPoint(
        name="kernels/lp_affinity",
        build=_build_lp_affinity,
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_ell_args(4),
                            lambda outs: [_np(outs)[:, :RING_N]]),
        kernels=(LP_LAUNCHES,),
    ),
    EntryPoint(
        name="kernels/sep_affinity",
        build=_build_sep_affinity,
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_ell_args(3),
                            lambda outs: [_np(outs)[:, :RING_N]]),
        kernels=(LP_LAUNCHES,),
    ),
    EntryPoint(
        name="kernels/pin_count",
        build=_build_pin_count,
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_pin_count,
                            lambda outs: [_np(outs[0])[:, :HG_M],
                                          _np(outs[1])[:, :HG_M]]),
        kernels=(PIN_LAUNCHES,),
    ),
    EntryPoint(
        name="kernels/pin_count_csr",
        build=_build_pin_count_csr,
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_pin_count_csr,
                            lambda outs: [_np(outs)[:, :HG_M]]),
        kernels=(PIN_LAUNCHES,),
        allow_syncs=_CSR_SYNCS,
    ),
    EntryPoint(
        name="kernels/pin_affinity",
        build=_build_pin_affinity,
        tags=_T({"padding", "hygiene"}),
        padding=PaddingSpec(_perturb_pin_affinity,
                            lambda outs: [_np(outs)[:, :HG_N]]),
        kernels=(PIN_LAUNCHES,),
    ),
    EntryPoint(
        name="kernels/ssd_scan",
        build=_build_ssd,
        tags=_T({"hygiene"}),
        kernels=(SSD_LAUNCHES,),
    ),
    EntryPoint(
        name="kernels/attention",
        build=_build_attention,
        tags=_T({"hygiene"}),
        kernels=(ATTN_LAUNCHES,),
    ),
    EntryPoint(
        name="serve/prefill_step1",
        build=_build_prefill_step1,
        tags=_T({"hygiene"}),
    ),
    EntryPoint(
        name="serve/decode_slots",
        build=_build_decode_slots,
        tags=_T({"hygiene"}),
    ),
    EntryPoint(
        name="serve/moe_gate_tap",
        build=_build_moe_gate_tap,
        tags=_T({"hygiene"}),
        allow_syncs=(("models/moe.py:_emit_gates", _GATE_TAP),),
    ),
)


def default_registry() -> Dict[str, EntryPoint]:
    return {e.name: e for e in ENTRIES}


#: public driver (interface.py) -> entry names that cover its device
#: programs; the registry lint fails when a driver is missing here or
#: names an unknown entry.
DRIVER_ENTRIES: Dict[str, Tuple[str, ...]] = {
    "kaffpa": ("engine/kway_refine", "engine/kway_refine_kernel",
               "engine/kway_lp_round", "engine/cluster_lp"),
    "kaffpa_balance_NE": ("engine/kway_refine",),
    "kaffpaE": ("engine/kway_refine", "memetic/migrate_ring"),
    "kahypar": ("engine/hyper_refine_km1", "engine/hyper_refine_cut",
                "engine/cluster_lp", "kernels/pin_count_csr"),
    "kahyparE": ("engine/hyper_refine_km1", "memetic/migrate_ring"),
    "parhyp": ("dist/parhyp_round", "dist/parhyp_round_2d",
               "dist/cluster_round", "dist/contract"),
    "node_separator": ("engine/sep_refine", "engine/cluster_lp"),
    "reduced_nd": ("engine/sep_refine", "engine/kway_refine"),
    "fast_reduced_nd": ("engine/sep_refine", "engine/kway_refine"),
    "process_mapping": ("engine/kway_refine",),
}
