"""Port parity: KaBaPE (`repro_torch.core.kabape`) against the JAX package.

The gain matrix is an integer affinity sum reduced per (block, block) pair
with ``np.argmax``'s tie rule (the lowest vertex id of the source block),
so on the same partition it must equal the reference's bit for bit —
through the ELL route (``ops.lp_affinity``: the CUDA kernel on a card,
its plain version here) and the COO route alike.  The negative-cycle
search, the negative-cycle refinement and the balancing paths are host
code over those matrices and must return the same arrays.  The full
polish runs the port's own refinement noise, so it is held to its
contract: strictly balanced output.
"""
import numpy as np
import pytest

from repro.core import csr as rcsr
from repro.core import kabape as rKB
from repro.io import generators as rgen

from repro_torch.core import csr as tcsr
from repro_torch.core import kabape as tKB
from repro_torch.core import kaffpa as tK
from repro_torch.core.partition import block_weights, edge_cut, is_feasible
from repro_torch.io import generators as tgen


def _pair(rows, cols, weighted):
    """grid2d(rows, cols) in both packages, with random symmetric integer
    edge weights in [1, 4] when ``weighted``."""
    g = rgen.grid2d(rows, cols)
    src = g.edge_sources()
    keep = src < g.adjncy
    u, v = src[keep], g.adjncy[keep]
    w = (np.random.default_rng(rows).integers(1, 5, len(u)) if weighted
         else np.ones(len(u), np.int64))
    return (rcsr.Graph.from_edges(g.n, u, v, w),
            tcsr.Graph.from_edges(g.n, u, v, w))


def _partitions(g, k):
    """A kaffpa partition, the same with 10% of vertices moved at random,
    a random labelling, a deliberately unbalanced one and one with an
    empty block."""
    rng = np.random.default_rng(k)
    base = tK.kaffpa(g, k, 0.03, "fast", seed=3, device="cpu")
    noisy = base.copy()
    idx = rng.choice(g.n, g.n // 10, replace=False)
    noisy[idx] = rng.integers(0, k, len(idx))
    skew = np.zeros(g.n, np.int64)
    skew[: g.n // 8] = 1
    skew[g.n // 8: g.n // 4] = 2
    skew[g.n // 4: g.n // 2 + 10] = k - 1
    empty = np.where(base == 1, 0, base)
    return {"kaffpa": base, "noisy": noisy,
            "random": rng.integers(0, k, g.n), "skewed": skew,
            "empty_block": empty}


CASES = [(12, 12, False, 4), (16, 10, True, 4), (9, 14, True, 6)]


@pytest.mark.parametrize("rows,cols,weighted,k", CASES)
def test_gain_matrix_bit_for_bit(rows, cols, weighted, k):
    rg, tg = _pair(rows, cols, weighted)
    coo = tcsr.to_coo(tg, device="cpu")
    ell = tcsr.to_ell(tg, row_tile=coo.n_pad, device="cpu")
    for name, part in _partitions(tg, k).items():
        want_g, want_n = rKB._gain_matrix(rg, part, k)
        for route in ({"coo": coo}, {"coo": coo, "ell": ell},
                      {"ell": ell, "device": "cpu"}, {"device": "cpu"}):
            got_g, got_n = tKB._gain_matrix(tg, part, k, **route)
            assert got_g.dtype == want_g.dtype and got_n.dtype == want_n.dtype
            assert np.array_equal(got_g, want_g), (name, route.keys())
            assert np.array_equal(got_n, want_n), (name, route.keys())


def test_bellman_ford_negative_cycle_matches():
    rng = np.random.default_rng(0)
    found = 0
    for t in range(60):
        k = int(rng.integers(2, 9))
        cost = rng.integers(-4, 8, (k, k)).astype(np.float64)
        cost[rng.random((k, k)) < 0.3] = np.inf
        np.fill_diagonal(cost, np.inf)
        want = rKB._bellman_ford_negative_cycle(cost)
        got = tKB._bellman_ford_negative_cycle(cost.copy())
        assert got == want, t
        found += want is not None
    assert 0 < found < 60


@pytest.mark.parametrize("rows,cols,weighted,k", CASES)
def test_negative_cycle_refine_and_balance_path_bit_for_bit(rows, cols,
                                                            weighted, k):
    rg, tg = _pair(rows, cols, weighted)
    coo = tcsr.to_coo(tg, device="cpu")
    ell = tcsr.to_ell(tg, row_tile=coo.n_pad, device="cpu")
    for name, part in _partitions(tg, k).items():
        for eps in (0.0, 0.03):
            want = rKB.negative_cycle_refine(rg, part, k, eps)
            assert np.array_equal(tKB.negative_cycle_refine(
                tg, part, k, eps, device="cpu"), want), (name, eps)
            assert np.array_equal(tKB.negative_cycle_refine(
                tg, part, k, eps, coo=coo, ell=ell), want), (name, eps)
            want = rKB.balance_path(rg, part, k, eps)
            assert np.array_equal(tKB.balance_path(
                tg, part, k, eps, device="cpu"), want), (name, eps)
            assert np.array_equal(tKB.balance_path(
                tg, part, k, eps, coo=coo, ell=ell), want), (name, eps)


def test_balance_path_fixes_infeasible():
    g = tgen.grid2d(12, 12)
    p = np.zeros(g.n, dtype=np.int64)
    p[: g.n // 8] = 1
    p[g.n // 8: g.n // 4] = 2
    p[g.n // 4: g.n // 2 + 40] = 3
    assert is_feasible(g, tKB.balance_path(g, p, 4, eps=0.0, device="cpu"),
                       4, 0.0)


def test_kabape_refine_perfect_balance():
    """tests/test_partitioning.py::test_kabape_perfect_balance on the port:
    strictly balanced, at most 1.2x the input's cut, with and without the
    caller's views."""
    g = tgen.grid2d(12, 12)
    p = tK.kaffpa(g, 4, 0.03, "fast", seed=3, device="cpu")
    coo = tcsr.to_coo(g, device="cpu")
    for kw in (dict(device="cpu"), dict(coo=coo)):
        p2 = tKB.kabape_refine(g, p, 4, eps=0.0, seed=1, **kw)
        assert is_feasible(g, p2, 4, 0.0)
        assert edge_cut(g, p2) <= edge_cut(g, p) * 1.2


@pytest.mark.parametrize("side,k", [(10, 4), (24, 8)])
def test_kabapeE_strictly_balanced(side, k):
    g = tgen.grid2d(side, side)
    part = tKB.kabapeE(g, k, eps=0.0, preset="fast", n_islands=2,
                       population=2, generations=2, seed=4, device="cpu")
    bw = block_weights(g, part, k)
    assert bw.max() <= int(np.ceil(g.n / k))
    assert is_feasible(g, part, k, 0.0)
