"""Port parity: host containers, generators, IO, device views and metrics of
`repro_torch` against `repro`, on the CPU."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import csr as rcsr
from repro.core import partition as rpart
from repro.core import coarsen as rcoarsen
from repro.core import initial as rinit
from repro.io import generators as rgen
from repro.io import metis as rmetis

from repro_torch.core import csr as tcsr
from repro_torch.core import partition as tpart
from repro_torch.core import coarsen as tcoarsen
from repro_torch.core import initial as tinit
from repro_torch.io import generators as tgen
from repro_torch.io import metis as tmetis

CPU = torch.device("cpu")

# (name, args) of every graph generator the port carries, at small sizes
GENERATORS = [
    ("grid2d", (7, 9)), ("grid3d", (4, 5, 3)), ("rmat", (7,)),
    ("barabasi_albert", (200, 3)), ("watts_strogatz", (150, 6, 0.1)),
    ("random_geometric", (200,)), ("erdos_renyi", (180, 6.0)),
    ("weighted_grid", (6, 6)),
]


def _graph_pair(name, args, seed=1):
    ref = getattr(rgen, name)(*args, seed=seed) if name != "grid3d" \
        else rgen.grid3d(*args)
    port = getattr(tgen, name)(*args, seed=seed) if name != "grid3d" \
        else tgen.grid3d(*args)
    return ref, port


def _csr_equal(a, b):
    for f in ("xadj", "adjncy", "vwgt", "adjwgt"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name,args", GENERATORS)
def test_generators_match_reference(name, args):
    ref, port = _graph_pair(name, args)
    _csr_equal(ref, port)
    assert port.check(raise_on_error=False) == []


# graphs of test_graph_io.py::test_device_views, plus one whose n lands
# exactly on its bucket (padding ids alias a real vertex) and a skewed one
VIEW_GRAPHS = [("weighted_grid", (6, 6)), ("grid2d", (16, 16)),
               ("barabasi_albert", (300, 3))]


@pytest.mark.parametrize("name,args", VIEW_GRAPHS)
def test_coo_view_matches_reference(name, args):
    ref_g, port_g = _graph_pair(name, args)
    ref = rcsr.to_coo(ref_g)
    port = tcsr.to_coo(port_g, device=CPU)
    for f in ("src", "dst", "w", "vwgt"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    assert port.e_pad % 256 == 0
    assert float(port.w.sum()) == float(port_g.adjwgt.sum())


@pytest.mark.parametrize("dmax_cap", [None, 4])
@pytest.mark.parametrize("name,args", VIEW_GRAPHS)
def test_ell_view_matches_reference(name, args, dmax_cap):
    ref_g, port_g = _graph_pair(name, args)
    coo_np = rcsr.to_coo(ref_g).n_pad
    ref = rcsr.to_ell(ref_g, row_tile=coo_np, dmax_cap=dmax_cap)
    port = tcsr.to_ell(port_g, row_tile=coo_np, dmax_cap=dmax_cap,
                       device=CPU)
    for f in ("nbr", "wgt", "vwgt"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    # padding slots: nbr == n_pad-1 with zero weight (the code, not the
    # stale nbr == -1 docstring of the reference)
    pad = port.wgt == 0
    assert bool((port.nbr[pad] == port.n_pad - 1).all())


def test_views_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    g = tgen.grid2d(4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcsr.to_coo(g)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcsr.resolve_device(None)
    assert tcsr.resolve_device("cpu") == CPU


def test_state_carry_over_round_trips():
    ref_g, port_g = _graph_pair("weighted_grid", (6, 6))
    ref_coo, ref_ell = rcsr.to_coo(ref_g), rcsr.to_ell(ref_g)
    coo = tcsr.coo_from_arrays(*(np.asarray(getattr(ref_coo, f))
                                 for f in ("src", "dst", "w", "vwgt")), CPU)
    ell = tcsr.ell_from_arrays(*(np.asarray(getattr(ref_ell, f))
                                 for f in ("nbr", "wgt", "vwgt")), CPU)
    own_coo = tcsr.to_coo(port_g, device=CPU)
    own_ell = tcsr.to_ell(port_g, device=CPU)
    for f in ("src", "dst", "w", "vwgt"):
        assert torch.equal(getattr(coo, f), getattr(own_coo, f))
    for f in ("nbr", "wgt", "vwgt"):
        assert torch.equal(getattr(ell, f), getattr(own_ell, f))
    # and back: the port's views rebuild the reference's
    back = rcsr.CooGraph(*(jnp.asarray(getattr(coo, f).numpy())
                           for f in ("src", "dst", "w", "vwgt")))
    for f in ("src", "dst", "w", "vwgt"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(ref_coo, f)))


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("name,args", VIEW_GRAPHS)
def test_device_cut_equals_host_cut(name, args, k):
    ref_g, port_g = _graph_pair(name, args)
    rng = np.random.default_rng(k)
    parts = rng.integers(0, k, (3, port_g.n))
    coo = tcsr.to_coo(port_g, device=CPU)
    labs = torch.zeros(3, coo.n_pad, dtype=torch.int32)
    labs[:, :port_g.n] = torch.from_numpy(parts)
    cuts = tpart.edge_cut_device(coo, labs)
    rcoo = rcsr.to_coo(ref_g)
    for i in range(3):
        host = tpart.edge_cut(port_g, parts[i])
        assert host == rpart.edge_cut(ref_g, parts[i])
        assert float(cuts[i]) == host
        assert float(rpart.edge_cut_device(rcoo, jnp.asarray(
            labs[i].numpy()))) == host
        bw = tpart.block_weights_device(coo, labs[i], k)
        np.testing.assert_array_equal(bw.numpy().astype(np.int64),
                                      tpart.block_weights(port_g, parts[i], k))


def test_host_metrics_match_reference():
    ref_g, port_g = _graph_pair("barabasi_albert", (300, 3))
    part = np.random.default_rng(0).integers(0, 4, port_g.n)
    assert tpart.evaluate(port_g, part, 4) == rpart.evaluate(ref_g, part, 4)


def test_host_coarsening_and_initial_match_reference():
    ref_g, port_g = _graph_pair("grid2d", (12, 10))
    a = rcoarsen.heavy_edge_matching(ref_g, seed=3, max_cluster_weight=4)
    b = tcoarsen.heavy_edge_matching(port_g, seed=3, max_cluster_weight=4)
    np.testing.assert_array_equal(a, b)
    (rc, rcl), (tc, tcl) = rcoarsen.contract(ref_g, a), \
        tcoarsen.contract(port_g, b)
    _csr_equal(rc, tc)
    np.testing.assert_array_equal(rcl, tcl)
    np.testing.assert_array_equal(rinit.recursive_bisection(ref_g, 4, seed=2),
                                  tinit.recursive_bisection(port_g, 4, seed=2))


def test_metis_io_matches_reference(tmp_path):
    _, g = _graph_pair("weighted_grid", (5, 4))
    path = str(tmp_path / "g.graph")
    tmetis.write_metis(g, path)
    _csr_equal(tmetis.read_metis(path), rmetis.read_metis(path))
    assert tmetis.graphchecker(path) == []
    bad = tmp_path / "bad.graph"
    bad.write_text("3 2\n2\n1 3\n2 4\n")
    assert tmetis.graphchecker(str(bad)) == rmetis.graphchecker(str(bad))
    assert tmetis.graphchecker(str(bad)) != []
