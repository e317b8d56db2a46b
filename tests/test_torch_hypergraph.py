"""Port parity: the hypergraph containers, views, hMETIS IO, generators,
metrics and coarsening of `repro_torch.core.hypergraph` against
`repro.core.hypergraph`.  Host structures and device views must be equal
array for array; device metrics must equal the host ones exactly (integer
sums in f32)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.hypergraph import container as rC
from repro.core.hypergraph import coarsen as rCo
from repro.core.hypergraph import initial as rI
from repro.core.hypergraph import metrics as rM
from repro.io import generators as rgen
from repro.io import hmetis as rio

from repro_torch.core.hypergraph import container as tC
from repro_torch.core.hypergraph import coarsen as tCo
from repro_torch.core.hypergraph import initial as tI
from repro_torch.core.hypergraph import metrics as tM
from repro_torch.io import generators as tgen
from repro_torch.io import hmetis as tio

CPU = torch.device("cpu")

GENERATORS = {
    "random_w": ("random_hypergraph", (120, 180), dict(seed=1, wmax=4)),
    "planted": ("planted_hypergraph", (120, 180), dict(blocks=4, seed=1)),
    "planted_w": ("planted_hypergraph", (150, 220),
                  dict(blocks=4, seed=3, wmax=3)),
    "grid": ("grid_hypergraph", (8, 8), {}),
    "rmat": ("rmat_hypergraph", (9,), dict(seed=2)),
    "rmat_chunked": ("rmat_hypergraph", (8,), dict(seed=5, chunk=64)),
}
FIELDS = ("vind", "vedges", "eptr", "eind", "vwgt", "ewgt")


def _pair(key):
    name, args, kw = GENERATORS[key]
    return getattr(rgen, name)(*args, **kw), getattr(tgen, name)(*args, **kw)


def _assert_same_hypergraph(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("key", list(GENERATORS))
def test_generators_identical(key):
    ref, port = _pair(key)
    _assert_same_hypergraph(ref, port)
    assert port.check() == []


def test_families_identical():
    assert set(rgen.FAMILIES_H) == set(tgen.FAMILIES_H)
    for name in tgen.FAMILIES_H:
        _assert_same_hypergraph(rgen.FAMILIES_H[name](seed=3),
                                tgen.FAMILIES_H[name](seed=3))


def test_constructors_and_checker_match_reference():
    nets = [[0, 1, 2], [2, 3], [3, 4, 0], [4, 4, 1]]
    _assert_same_hypergraph(rC.Hypergraph.from_nets(5, nets, ewgt=[1, 2, 3, 4]),
                            tC.Hypergraph.from_nets(5, nets, ewgt=[1, 2, 3, 4]))
    rng = np.random.default_rng(0)
    counts = rng.random((12, 12)) * 3
    load = rng.random(12) * 5
    sets = {(0, 3, 5): 2.4, (1, 2): 0.2, (4, 7, 8, 9): 1.6}
    _assert_same_hypergraph(
        rC.Hypergraph.from_coactivation(counts, load=load, sets=sets),
        tC.Hypergraph.from_coactivation(counts, load=load, sets=sets))
    # the checker flags the same faults
    for mutate in (lambda h: h.eind.__setitem__(0, 7),
                   lambda h: h.vedges.__setitem__(0, 1),
                   lambda h: h.ewgt.__setitem__(0, 0)):
        errs = []
        for mod in (rC, tC):
            h = mod.Hypergraph.from_nets(4, [[0, 1], [2, 3]])
            h.eind, h.vedges, h.ewgt = h.eind.copy(), h.vedges.copy(), \
                h.ewgt.copy()
            mutate(h)
            errs.append(h.check(raise_on_error=False))
        assert errs[0] == errs[1] and errs[1]
    dup = tC.Hypergraph.from_nets(4, [[0, 0, 1]], dedup_pins=False)
    with pytest.raises(tC.HypergraphFormatError):
        dup.check()


@pytest.mark.parametrize("key", ["random_w", "grid", "rmat"])
def test_views_identical(key):
    ref, port = _pair(key)
    rell, tell = rC.to_ell_h(ref), tC.to_ell_h(port, device=CPU)
    for f in ("vnets", "pins", "pin_mask", "netw", "vwgt"):
        np.testing.assert_array_equal(np.asarray(getattr(rell, f)),
                                      getattr(tell, f).numpy(), err_msg=f)
    assert (tell.n_pad, tell.e_pad, tell.pmax) == (rell.n_pad, rell.e_pad,
                                                   rell.pmax)
    rhc, thc = rC.to_pincoo(ref), tC.to_pincoo(port, device=CPU)
    for f in ("pv", "pe", "mask", "netw", "esize", "vwgt"):
        np.testing.assert_array_equal(np.asarray(getattr(rhc, f)),
                                      getattr(thc, f).numpy(), err_msg=f)
    assert (thc.n_pad, thc.e_pad, thc.p_pad) == (rhc.n_pad, rhc.e_pad,
                                                 rhc.p_pad)
    # the padding contract: e_pad > m, the last net row is a zero-weight
    # padding net, padding pins are (n_pad - 1, mask 0)
    assert thc.e_pad > port.m and float(thc.netw[-1]) == 0.0
    assert int((tell.vnets == tell.e_pad - 1).sum()) == \
        tell.vnets.numel() - port.pins
    pad = tell.pin_mask == 0
    assert bool((tell.pins[pad] == tell.n_pad - 1).all())
    assert bool((thc.pv[port.pins:] == thc.n_pad - 1).all())
    assert float(thc.mask[port.pins:].sum()) == 0.0


@pytest.mark.parametrize("key", ["random_w", "grid", "rmat"])
def test_pincoo_eptr_is_the_net_offsets_padded(key):
    """The port's PinCoo adds the net offsets the CSR pin-count entry reads:
    ``hg.eptr`` with every padding net empty at the end of the pins.  The
    fields it shares with the reference's PinCoo stay equal."""
    ref, port = _pair(key)
    rhc, thc = rC.to_pincoo(ref), tC.to_pincoo(port, device=CPU)
    for f in ("pv", "pe", "mask", "netw", "esize", "vwgt"):
        np.testing.assert_array_equal(np.asarray(getattr(rhc, f)),
                                      getattr(thc, f).numpy(), err_msg=f)
    eptr = thc.eptr.numpy()
    assert eptr.dtype == np.int32 and eptr.shape == (thc.e_pad + 1,)
    np.testing.assert_array_equal(eptr[:port.m + 1], port.eptr)
    assert (eptr[port.m:] == port.pins).all()
    # the pins are in net order: pe is the expansion of eptr
    np.testing.assert_array_equal(
        thc.pe.numpy()[:port.pins],
        np.repeat(np.arange(thc.e_pad), np.diff(eptr)))


def test_device_none_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    hg = tgen.grid_hypergraph(4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tC.to_pincoo(hg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tC.to_ell_h(hg)


# -- hMETIS IO ---------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_hmetis_roundtrip_matches_reference(tmp_path, weighted):
    _, hg = _pair("random_w")
    if not weighted:
        hg.ewgt = np.ones(hg.m, dtype=np.int64)
    else:
        hg.vwgt = np.random.default_rng(0).integers(1, 6, hg.n)
    p_port, p_ref = str(tmp_path / "port.hgr"), str(tmp_path / "ref.hgr")
    tio.write_hmetis(hg, p_port)
    rio.write_hmetis(rC.Hypergraph(hg.vind, hg.vedges, hg.eptr, hg.eind,
                                   hg.vwgt, hg.ewgt), p_ref)
    assert open(p_port).read() == open(p_ref).read()
    _assert_same_hypergraph(tio.read_hmetis(p_port), rio.read_hmetis(p_ref))
    _assert_same_hypergraph(tio.read_hmetis(p_port), hg)
    assert tio.hypergraphchecker(p_port) == []


MALFORMED = {
    "count": "2 3 1\n5 1 2\n",          # header says 2 nets, file has 1
    "header": "2\n1 2\n",
    "range": "1 3\n1 4\n",              # pin 4 of 3 vertices
    "zero_id": "1 3\n0 2\n",            # pins are 1-indexed
    "duplicate": "1 3\n1 1 2\n",
    "empty_net": "1 3 1\n5\n",
    "weight": "1 3 1\n0 1 2\n",         # non-positive net weight
    "vertex_weights": "1 2 10\n1 2\n3\n",
    "token": "1 3\n1 x\n",
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_hmetis_rejects_malformed(tmp_path, case):
    """The port of test_hypergraph.py::test_hmetis_rejects_malformed, plus
    more faults: the checker returns errors where the reference does, and
    never raises."""
    p = str(tmp_path / "bad.hgr")
    with open(p, "w") as f:
        f.write(MALFORMED[case])
    errs = tio.hypergraphchecker(p)
    assert errs != [] and all(isinstance(e, str) for e in errs)
    assert rio.hypergraphchecker(p) != []


def test_hmetis_checker_never_raises_on_missing_file(tmp_path):
    assert tio.hypergraphchecker(str(tmp_path / "missing.hgr")) != []


# -- metrics -----------------------------------------------------------------

def test_objectives_on_known_partition():
    hg = tC.Hypergraph.from_nets(4, [[0, 1], [0, 2, 3], [2, 3]],
                                 ewgt=[1, 5, 2])
    part = np.array([0, 0, 1, 1])
    assert np.array_equal(tM.net_lambdas(hg, part), [1, 2, 1])
    assert tM.cut_net(hg, part) == 5 and tM.connectivity(hg, part) == 5


@pytest.mark.parametrize("key", ["random_w", "planted_w", "rmat"])
def test_metrics_match_reference_host_and_batched_device(key):
    ref, port = _pair(key)
    k, b = 5, 3
    rng = np.random.default_rng(4)
    parts = rng.integers(0, k, (b, port.n))
    for p in parts:
        assert tM.evaluate(port, p, k) == rM.evaluate(ref, p, k)
        np.testing.assert_array_equal(tM.net_lambdas(port, p),
                                      rM.net_lambdas(ref, p))
    rhc, thc = rC.to_pincoo(ref), tC.to_pincoo(port, device=CPU)
    labs = np.zeros((b, thc.n_pad), np.int32)
    labs[:, :port.n] = parts
    cnt = tM.pin_counts_device(thc, torch.from_numpy(labs), k)
    assert cnt.shape == (b, thc.e_pad, k)
    km1 = tM.km1_device(cnt, thc.netw).numpy()
    cut = tM.cut_net_device(cnt, thc.netw).numpy()
    for i, p in enumerate(parts):
        rcnt = rM.pin_counts_device(rhc, jnp.asarray(labs[i]), k)
        np.testing.assert_array_equal(cnt[i].numpy(), np.asarray(rcnt))
        assert km1[i] == float(rM.km1_device(rcnt, rhc.netw))
        assert cut[i] == float(rM.cut_net_device(rcnt, rhc.netw))
        assert km1[i] == tM.connectivity(port, p)
        assert cut[i] == tM.cut_net(port, p)


# -- coarsening and initial partitioning ------------------------------------

def test_contract_preserves_weight_and_objectives():
    ref, port = _pair("planted_w")
    clusters = np.arange(port.n) // 3          # triples of vertices merge
    coarse, cl = tCo.contract(port, clusters)
    rcoarse, rcl = rCo.contract(ref, clusters)
    _assert_same_hypergraph(coarse, rcoarse)
    np.testing.assert_array_equal(cl, rcl)
    assert coarse.check() == []
    assert coarse.total_vwgt() == port.total_vwgt()
    assert coarse.net_sizes().min() >= 2       # single-pin nets dropped
    part_c = np.random.default_rng(0).integers(0, 3, coarse.n)
    part_f = tCo.project(part_c, cl)
    assert tM.connectivity(coarse, part_c) == tM.connectivity(port, part_f)
    assert tM.cut_net(coarse, part_c) == tM.cut_net(port, part_f)


def test_expansions_match_reference():
    ref, port = _pair("random_w")
    for fn in ("clique_expansion", "star_expansion"):
        a, b = getattr(rCo, fn)(ref), getattr(tCo, fn)(port)
        for f in ("xadj", "adjncy", "vwgt", "adjwgt"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert b.check() == []
    assert tCo.star_expansion(port).m == port.pins


def test_star_fallback_gives_signal():
    """Port of test_multilevel.py::test_large_net_star_fallback_gives_signal."""
    hg = tC.Hypergraph.from_nets(64, [list(range(64))])
    off = tCo.clique_expansion(hg, max_net_size=16, large_net_fallback=False)
    assert len(off.adjncy) == 0
    on = tCo.clique_expansion(hg, max_net_size=16)
    assert len(on.adjncy) == 2 * 63           # star around the first pin
    res = tCo.coarsen_level(hg, max_cluster_weight=8, seed=0,
                            max_net_size=16, device=CPU)
    assert res is not None
    coarse, _ = res
    assert coarse.n < hg.n and coarse.total_vwgt() == hg.total_vwgt()


def test_lp_clustering_respects_weight_and_protection():
    _, port = _pair("planted")
    protect = [np.arange(port.n) % 2]
    cl = tCo.lp_clustering(port, 6.0, seed=1, protect=protect, device=CPU)
    assert len(np.unique(cl)) < port.n
    assert np.bincount(cl, weights=port.vwgt).max() <= 6


def test_initial_partitions_match_reference():
    ref, port = _pair("planted")
    for k in (2, 4):
        np.testing.assert_array_equal(tI.greedy_growing(port, k, seed=3),
                                      rI.greedy_growing(ref, k, seed=3))
        np.testing.assert_array_equal(tI.random_partition(port, k, seed=3),
                                      rI.random_partition(ref, k, seed=3))
    assert set(np.unique(tI.greedy_growing(port, 4, seed=0))) == {0, 1, 2, 3}
