"""Port parity: process mapping (`repro_torch.core.mapping`), the exact
solver / ILP improvement (`repro_torch.core.ilp`) and the device-topology
mapping (`repro_torch.launch.topology`) against the JAX package.

The QAP machinery, the swap search, the branch and bound and the model
construction are host numpy copies and must return the same arrays.  The
mapping's multisection runs kaffpa underneath, with the port's own noise,
so the whole mapping is held to the reference's band (summed QAP over 3
seeds ≤ 1.15× the reference's) and must beat the identity on the
clustered pattern of tests/test_tools.py.
"""
import numpy as np
import pytest

from repro.core import csr as rcsr
from repro.core import ilp as rILP
from repro.core import mapping as rM
from repro.launch import topology as rT
from repro.io import generators as rgen

from repro_torch.core import csr as tcsr
from repro_torch.core import ilp as tILP
from repro_torch.core import interface as tif
from repro_torch.core import kaffpa as tK
from repro_torch.core import mapping as tM
from repro_torch.core.partition import edge_cut, is_feasible
from repro_torch.launch import topology as tT
from repro_torch.io import generators as tgen

BAND = 1.15
SEEDS = (1, 2, 3)


def _clustered(k=16, seed=0):
    """4 chatty cliques scattered across ids: the identity mapping is bad."""
    rng = np.random.default_rng(seed)
    comm = np.zeros((k, k), dtype=np.int64)
    perm = rng.permutation(k)
    for c in range(4):
        ids = perm[c * 4:(c + 1) * 4]
        for i in ids:
            for j in ids:
                if i != j:
                    comm[i, j] = 100
    return comm


def _random_comm(k, seed, density=0.4):
    rng = np.random.default_rng(seed)
    c = rng.integers(1, 50, (k, k)) * (rng.random((k, k)) < density)
    c = np.triu(c, 1)
    return (c + c.T).astype(np.int64)


# -- host pieces, bit for bit -------------------------------------------------

@pytest.mark.parametrize("h,d", [("4:8:8", "1:10:100"), ([2, 2], [1, 10]),
                                 ("3:5", [1, 7]), ([16], "5")])
def test_parse_hierarchy_and_distance_matrix(h, d):
    got, want = tM.parse_hierarchy(h, d), rM.parse_hierarchy(h, d)
    assert got == want
    dt, dr = (tM.processor_distance_matrix(*got),
              rM.processor_distance_matrix(*want))
    assert dt.dtype == dr.dtype and np.array_equal(dt, dr)
    with pytest.raises(ValueError):
        tM.parse_hierarchy("4:4", "1")
    with pytest.raises(ValueError):
        tM.process_mapping(np.zeros((3, 3), np.int64), [2, 2], [1, 10],
                           device="cpu")
    with pytest.raises(ValueError):
        tT.choose_axis_assignment({"a": 1.0}, {"a": 4}, hierarchy=(2, 4),
                                  device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qap_cost_and_swap_search_bit_for_bit(seed):
    h, d = [4, 2, 2], [1, 10, 100]
    dist = rM.processor_distance_matrix(h, d)
    rng = np.random.default_rng(seed)
    for comm in (_random_comm(16, seed), _clustered(16, seed)):
        mapping = rng.permutation(16)
        assert tM.qap_cost(comm, dist, mapping) == rM.qap_cost(comm, dist,
                                                               mapping)
        for iters in (1, 3):
            got = tM._swap_local_search(comm, dist, mapping, iters)
            assert np.array_equal(got, rM._swap_local_search(comm, dist,
                                                             mapping, iters))
            assert tM.qap_cost(comm, dist, got) <= tM.qap_cost(comm, dist,
                                                               mapping)


def test_topology_functions_bit_for_bit():
    sizes = {"data": 2, "fsdp": 2, "model": 4}
    collective = {"data": 3.0e9, "fsdp": 8.0e8, "model": 1.2e10, "pod": 7.0}
    assert (tT.collective_traffic_by_axis(collective, sizes)
            == rT.collective_traffic_by_axis(collective, sizes))
    pairs = np.arange(16.0).reshape(4, 4)
    assert tT.axis_comm_matrix(pairs) is pairs
    assert rT.axis_comm_matrix(pairs) is pairs
    axis_bytes = tT.collective_traffic_by_axis(collective, sizes)
    got = tT.build_device_comm_matrix(axis_bytes, sizes)
    want = rT.build_device_comm_matrix(axis_bytes, sizes)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    out = tT.choose_axis_assignment(axis_bytes, sizes, hierarchy=(4, 2, 2),
                                    seed=1, device="cpu")
    ref = rT.choose_axis_assignment(axis_bytes, sizes, hierarchy=(4, 2, 2),
                                    seed=1)
    assert out["identity_qap"] == ref["identity_qap"]
    assert sorted(out["mapping"].tolist()) == list(range(16))
    assert out["qap"] == tM.qap_cost(got.astype(np.int64),
                                     tM.processor_distance_matrix(
                                         [4, 2, 2], [1, 10, 100]),
                                     out["mapping"])
    assert out["improvement"] == (0.0 if out["identity_qap"] == 0 else
                                  1.0 - out["qap"] / out["identity_qap"])
    assert out["qap"] <= BAND * ref["qap"]


# -- the whole mapping: the reference's band ----------------------------------

def test_process_mapping_improves_clustered_pattern():
    comm = _clustered()
    dist = tM.processor_distance_matrix([4, 4], [1, 10])
    ident = tM.qap_cost(comm, dist, np.arange(16))
    got, want = [], []
    for s in SEEDS:
        mapping = tM.process_mapping(comm, "4:4", "1:10", seed=s,
                                     device="cpu")
        assert sorted(mapping.tolist()) == list(range(16))
        got.append(tM.qap_cost(comm, dist, mapping))
        assert got[-1] < ident
        want.append(rM.qap_cost(comm, dist, rM.process_mapping(
            comm, "4:4", "1:10", seed=s)))
    assert sum(got) <= BAND * sum(want), (got, want)


def test_bisection_mode_starts_from_identity():
    comm = _random_comm(8, 3)
    got = tM.process_mapping(comm, [2, 4], [1, 10],
                             mode=tM.MAPMODE_BISECTION, device="cpu")
    assert np.array_equal(got, rM.process_mapping(
        comm, [2, 4], [1, 10], mode=rM.MAPMODE_BISECTION))
    assert np.array_equal(tM.process_mapping(
        comm, [2, 4], [1, 10], mode=tM.MAPMODE_BISECTION,
        local_search=False, device="cpu"), np.arange(8))


def test_kaffpa_with_mapping_and_interface():
    g = tgen.grid2d(16, 16)
    part, mapping, qap = tM.kaffpa_with_mapping(g, "2:2", "1:10", 0.03,
                                                "fast", seed=1, device="cpu")
    assert sorted(np.unique(part).tolist()) == [0, 1, 2, 3]
    assert sorted(mapping.tolist()) == [0, 1, 2, 3] and qap >= 0
    cut, qap2, final = tif.process_mapping(
        g.n, None, g.xadj, None, g.adjncy, [4, 4, 9], [1, 10, 99], 2, 0.03,
        seed=1, mode_partitioning=tif.FAST, device="cpu")
    assert cut == edge_cut(g, final) and is_feasible(g, final, 16, 0.03)
    assert qap2 >= 0 and sorted(np.unique(final).tolist()) == list(range(16))


# -- exact solver and ILP improvement ----------------------------------------

def test_exact_solver_optimal_on_cycle():
    n = 8
    u, v = np.arange(n), (np.arange(n) + 1) % n
    g = tcsr.Graph.from_edges(n, u, v)
    part = tILP.ilp_exact(g, 2, 0.0, timeout=30, seed=1, device="cpu")
    want = rILP.ilp_exact(rcsr.Graph.from_edges(n, u, v), 2, 0.0,
                          timeout=30, seed=1)
    assert edge_cut(g, part) == edge_cut(g, want) == 2
    assert is_feasible(g, part, 2, 0.0)


@pytest.mark.parametrize("fixed", [False, True])
def test_exact_branch_and_bound_bit_for_bit(fixed):
    """The branch and bound is deterministic host code: the same optimum
    and the same partition."""
    rng = np.random.default_rng(4)
    n = 11
    u = rng.integers(0, n, 24)
    v = (u + rng.integers(1, n, 24)) % n
    w = rng.integers(1, 6, 24)
    tg, rg = (tcsr.Graph.from_edges(n, u, v, w),
              rcsr.Graph.from_edges(n, u, v, w))
    fx = None
    if fixed:
        fx = -np.ones(n, np.int64)
        fx[:3] = [0, 1, 2]
    lmax = 1.2 * np.ceil(n / 3)
    got = tILP._exact_bb(tg, 3, lmax, fx, timeout=30)
    want = rILP._exact_bb(rg, 3, lmax, fx, timeout=30)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])


@pytest.mark.parametrize("mode", ["boundary", "gain"])
def test_build_model_bit_for_bit(mode):
    g = tgen.grid2d(12, 12)
    rg = rgen.grid2d(12, 12)
    part = tK.kaffpa(g, 4, 0.03, "fast", seed=11, device="cpu")
    tm, tf, tfree = tILP.build_model(g, part, 4, mode)
    rm, rf, rfree = rILP.build_model(rg, part, 4, mode)
    assert np.array_equal(tfree, rfree) and np.array_equal(tf, rf)
    for a in ("xadj", "adjncy", "vwgt", "adjwgt"):
        assert np.array_equal(getattr(tm, a), getattr(rm, a)), a


@pytest.mark.parametrize("seed", SEEDS)
def test_ilp_improve_never_worsens(seed):
    g = tgen.grid2d(12, 12)
    part = tK.kaffpa(g, 4, 0.03, "fast", seed=seed + 10, device="cpu")
    out = tILP.ilp_improve(g, part, 4, timeout=15, seed=1)
    assert edge_cut(g, out) <= edge_cut(g, part)
    assert is_feasible(g, out, 4, 0.03)
    # on the same partition the host solve is the reference's
    assert np.array_equal(out, rILP.ilp_improve(rgen.grid2d(12, 12), part, 4,
                                                timeout=15, seed=1))
