"""Synthetic graph and hypergraph families used by tests and benchmarks.

Two regimes mirror the paper's preset split: *mesh-like* (grids, tori,
geometric graphs — what fast/eco/strong target) and *social/web-like*
(power-law RMAT, Barabási–Albert, Watts–Strogatz — what the ``*social``
presets and ParHIP target).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import Graph
from repro_torch.core.hypergraph.container import Hypergraph


def grid2d(rows: int, cols: int, wrap: bool = False, seed: int = 0) -> Graph:
    """2-D grid (torus if wrap) — the canonical 'mesh' instance (Fig. 1)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    us, vs = [], []
    # horizontal
    us.append(idx[:, :-1].ravel()); vs.append(idx[:, 1:].ravel())
    us.append(idx[:-1, :].ravel()); vs.append(idx[1:, :].ravel())
    if wrap and cols > 2:
        us.append(idx[:, -1].ravel()); vs.append(idx[:, 0].ravel())
    if wrap and rows > 2:
        us.append(idx[-1, :].ravel()); vs.append(idx[0, :].ravel())
    u = np.concatenate(us); v = np.concatenate(vs)
    return Graph.from_edges(rows * cols, u, v)


def grid3d(nx: int, ny: int, nz: int) -> Graph:
    idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    us, vs = [], []
    us.append(idx[:-1].ravel()); vs.append(idx[1:].ravel())
    us.append(idx[:, :-1].ravel()); vs.append(idx[:, 1:].ravel())
    us.append(idx[:, :, :-1].ravel()); vs.append(idx[:, :, 1:].ravel())
    return Graph.from_edges(nx * ny * nz, np.concatenate(us), np.concatenate(vs))


def rmat(scale: int, edge_factor: int = 8, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Graph:
    """Kronecker/RMAT power-law generator (Graph500 parameters)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    u = np.zeros(m, dtype=np.int64)
    v = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        r = rng.random(m)
        ubit = (r >= ab).astype(np.int64)                       # rows c+d
        vbit = np.where(ubit == 1, (r >= abc), (r >= a)).astype(np.int64)
        u = (u << 1) | ubit
        v = (v << 1) | vbit
    # permute ids to kill locality
    perm = rng.permutation(n)
    return Graph.from_edges(n, perm[u], perm[v])


def barabasi_albert(n: int, m_attach: int = 3, seed: int = 0) -> Graph:
    """Preferential attachment — social-like degree distribution."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_attach))
    repeated: list = list(range(m_attach))
    us, vs = [], []
    for v in range(m_attach, n):
        picks = rng.choice(len(repeated), size=m_attach, replace=False)
        chosen = {repeated[p] for p in picks}
        for t in chosen:
            us.append(v); vs.append(t)
        repeated.extend(chosen)
        repeated.extend([v] * len(chosen))
    return Graph.from_edges(n, np.asarray(us), np.asarray(vs))


def watts_strogatz(n: int, k: int = 6, p: float = 0.1, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    us, vs = [], []
    for j in range(1, k // 2 + 1):
        u = np.arange(n)
        v = (u + j) % n
        rewire = rng.random(n) < p
        v = np.where(rewire, rng.integers(0, n, n), v)
        us.append(u); vs.append(v)
    return Graph.from_edges(n, np.concatenate(us), np.concatenate(vs))


def random_geometric(n: int, radius: float | None = None, seed: int = 0) -> Graph:
    """Unit-square geometric graph — mesh-like, used by DIMACS instances."""
    rng = np.random.default_rng(seed)
    if radius is None:
        radius = 1.8 * np.sqrt(1.0 / n)
    pts = rng.random((n, 2))
    # grid binning for near-linear neighbour search
    nb = max(1, int(1.0 / radius))
    cell = (pts // (1.0 / nb)).astype(np.int64)
    cid = cell[:, 0] * nb + cell[:, 1]
    order = np.argsort(cid)
    us, vs = [], []
    r2 = radius * radius
    # brute force within 3x3 neighbourhood via sorted cells
    from collections import defaultdict
    buckets = defaultdict(list)
    for i in range(n):
        buckets[(int(cell[i, 0]), int(cell[i, 1]))].append(i)
    for (cx, cy), members in buckets.items():
        cand = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                cand.extend(buckets.get((cx + dx, cy + dy), []))
        cand = np.asarray(cand)
        for i in members:
            d = pts[cand] - pts[i]
            close = cand[(d * d).sum(1) < r2]
            close = close[close > i]
            us.extend([i] * len(close)); vs.extend(close.tolist())
    return Graph.from_edges(n, np.asarray(us, dtype=np.int64),
                            np.asarray(vs, dtype=np.int64))


def erdos_renyi(n: int, avg_deg: float = 8.0, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    u = rng.integers(0, n, m * 2)
    v = rng.integers(0, n, m * 2)
    return Graph.from_edges(n, u, v)


def weighted_grid(rows: int, cols: int, seed: int = 0, wmax: int = 10) -> Graph:
    g = grid2d(rows, cols)
    rng = np.random.default_rng(seed)
    # symmetric random weights: assign per undirected edge then mirror
    n = g.n
    src = g.edge_sources()
    lo = np.minimum(src, g.adjncy)
    hi = np.maximum(src, g.adjncy)
    key = lo * np.int64(n) + hi
    uniq, inv = np.unique(key, return_inverse=True)
    w_und = rng.integers(1, wmax + 1, size=len(uniq))
    return Graph(g.xadj, g.adjncy, g.vwgt, w_und[inv].astype(np.int64))


# ---------------------------------------------------------------------------
# hypergraph families (repro_torch.core.hypergraph workloads)
# ---------------------------------------------------------------------------

def random_hypergraph(n: int, m: int, min_pins: int = 2, max_pins: int = 8,
                      seed: int = 0, wmax: int = 1):
    """Uniform random hypergraph: each net draws 2..max_pins distinct pins."""
    rng = np.random.default_rng(seed)
    nets = []
    for _ in range(m):
        sz = int(rng.integers(min_pins, max_pins + 1))
        nets.append(rng.choice(n, size=min(sz, n), replace=False))
    ewgt = rng.integers(1, wmax + 1, size=m) if wmax > 1 else None
    return Hypergraph.from_nets(n, nets, ewgt=ewgt)


def planted_hypergraph(n: int, m: int, blocks: int = 4,
                       p_cross: float = 0.1, min_pins: int = 2,
                       max_pins: int = 8, seed: int = 0, wmax: int = 1):
    """Planted-partition hypergraph: most nets draw all pins from one of
    ``blocks`` ground-truth groups; a ``p_cross`` fraction spans the whole
    vertex set.  The planted assignment is a near-optimal (λ−1) partition —
    the standard quality benchmark for data-placement workloads."""
    rng = np.random.default_rng(seed)
    home = np.arange(n) % blocks           # planted group of each vertex
    members = [np.flatnonzero(home == b) for b in range(blocks)]
    nets = []
    for _ in range(m):
        sz = int(rng.integers(min_pins, max_pins + 1))
        if rng.random() < p_cross:
            pool = np.arange(n)
        else:
            pool = members[int(rng.integers(0, blocks))]
        nets.append(rng.choice(pool, size=min(sz, len(pool)), replace=False))
    ewgt = rng.integers(1, wmax + 1, size=m) if wmax > 1 else None
    return Hypergraph.from_nets(n, nets, ewgt=ewgt)


def rmat_hypergraph(scale: int, net_factor: float = 1.0,
                    avg_pins: float = 6.0, max_pins: int = 64,
                    seed: int = 0, a: float = 0.57,
                    chunk: int = 1 << 18):
    """Streaming RMAT-style power-law hypergraph (the million-vertex
    ``parhyp_scale`` instance family): ``n = 2^scale`` vertices and
    ``~net_factor·n`` nets whose sizes follow a clipped Pareto tail and
    whose pins are drawn by 1-D bit-recursive skewed sampling (the RMAT
    recursion applied to a single id), so vertex degrees are heavy-tailed
    too.  Nets are generated in bounded chunks of ``chunk`` so peak
    transient memory stays O(chunk·avg_pins) over the final arrays —
    host-RSS-friendly at 1M+ nets."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = int(round(net_factor * n))
    perm = rng.permutation(n)
    eind_parts, size_parts = [], []
    done = 0
    while done < m:
        b = int(min(chunk, m - done))
        # clipped-Pareto net sizes with mean ~avg_pins
        sz = 2 + np.floor(1.5 * (avg_pins - 2.0)
                          * rng.pareto(2.5, b)).astype(np.int64)
        sz = np.minimum(sz, max_pins)
        total = int(sz.sum())
        v = np.zeros(total, dtype=np.int64)
        for _ in range(scale):
            v = (v << 1) | (rng.random(total) >= a)
        net = np.repeat(np.arange(b, dtype=np.int64), sz)
        # dedup pins within each net (sort on the flat (net, vertex) key)
        flat = np.sort(net * n + v, kind="stable")
        keep = np.concatenate([[True], flat[1:] != flat[:-1]])
        flat = flat[keep]
        net_k, v_k = flat // n, flat % n
        cnt = np.bincount(net_k, minlength=b)
        # single-pin nets carry no objective — drop them
        ok = cnt >= 2
        keep_pin = ok[net_k]
        eind_parts.append(perm[v_k[keep_pin]])
        size_parts.append(cnt[ok])
        done += b
    sizes = np.concatenate(size_parts)
    eptr = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=eptr[1:])
    return Hypergraph.from_arrays(n, eptr, np.concatenate(eind_parts))


def grid_hypergraph(rows: int, cols: int):
    """Each 2×2 window of a grid becomes a 4-pin net — mesh-like, low λ."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    nets = []
    for i in range(rows - 1):
        for j in range(cols - 1):
            nets.append([idx[i, j], idx[i, j + 1],
                         idx[i + 1, j], idx[i + 1, j + 1]])
    return Hypergraph.from_nets(rows * cols, nets)


FAMILIES_H = {
    "hrand": lambda seed=0: random_hypergraph(2048, 3072, seed=seed),
    "hplant": lambda seed=0: planted_hypergraph(2048, 3072, blocks=8,
                                                seed=seed),
    "hgrid": lambda seed=0: grid_hypergraph(40, 40),
    "hrmat": lambda seed=0: rmat_hypergraph(11, seed=seed),
}
