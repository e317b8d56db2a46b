"""Port parity: nested-dissection orderings (`repro_torch.core.ordering`)
against `repro.core.ordering`.

The reductions and minimum degree are host copies and must give the same
arrays.  The separators draw noise from another generator than the
reference's, so fill-in is held to the band: the sum over 3 seeds ≤ 1.15×
the reference's, run in the same process.
"""
import numpy as np
import pytest

from repro.core import interface as rif
from repro.core import ordering as rO
from repro.io import generators as rgen

from repro_torch.core import interface as tif
from repro_torch.core import ordering as tO
from repro_torch.io import generators as tgen

BAND = 1.15

#: (generator, args): a grid (few reductions), a graph with degree-2 chains
#: and twins (many), a power-law graph
GRAPHS = [("grid2d", (9, 11)), ("watts_strogatz", (120, 4, 0.05, 3)),
          ("barabasi_albert", (150, 2, 4))]


@pytest.mark.parametrize("name,args", GRAPHS, ids=[n for n, _ in GRAPHS])
@pytest.mark.parametrize("rules", [(0, 1, 2, 3, 4), (0, 3, 4), (5, 1, 2)],
                         ids=["eco", "fast", "tri"])
def test_reductions_match_reference(name, args, rules):
    rg, tg = getattr(rgen, name)(*args), getattr(tgen, name)(*args)
    rk, rids, rprefix, rfollow = rO.apply_reductions(rg, rules)
    tk, tids, tprefix, tfollow = tO.apply_reductions(tg, rules)
    np.testing.assert_array_equal(tids, rids)
    assert tprefix == rprefix and tfollow == rfollow
    for f in ("xadj", "adjncy", "vwgt", "adjwgt"):
        np.testing.assert_array_equal(getattr(tk, f), getattr(rk, f))
    np.testing.assert_array_equal(tO._min_degree_order(tk),
                                  rO._min_degree_order(rk))
    order = rO._min_degree_order(rg)
    assert tO.fill_in(tg, order) == rO.fill_in(rg, order)


def test_nd_wave_equals_sequential():
    """Port of test_bucketing.py::test_nd_wave_equals_sequential: the wave
    (stacked sibling tournaments) orders exactly as the recursion."""
    g = tgen.grid2d(13, 13)
    seq = tO.reduced_nd(g, preset="fast", seed=2, batch_siblings=False,
                        device="cpu")
    wave = tO.reduced_nd(g, preset="fast", seed=2, batch_siblings=True,
                         device="cpu")
    np.testing.assert_array_equal(seq, wave)


@pytest.mark.parametrize("preset", ["eco", "fast"])
def test_fill_in_within_band_of_reference(preset):
    rg, tg = rgen.grid2d(16, 16), tgen.grid2d(16, 16)
    ref_fill = port_fill = 0
    for s in (1, 2, 3):
        if preset == "fast":
            want = rO.fast_reduced_nd(rg, seed=s)
            got = tO.fast_reduced_nd(tg, seed=s, device="cpu")
        else:
            want = rO.reduced_nd(rg, seed=s)
            got = tO.reduced_nd(tg, seed=s, device="cpu")
        np.testing.assert_array_equal(np.sort(got), np.arange(tg.n))
        ref_fill += rO.fill_in(rg, want)
        port_fill += tO.fill_in(tg, got)
    assert port_fill <= BAND * ref_fill, (port_fill, ref_fill)


@pytest.mark.parametrize("entry", ["reduced_nd", "fast_reduced_nd"])
def test_interface_returns_inverse_permutation(entry):
    g = tgen.grid2d(12, 12)
    inv = getattr(tif, entry)(g.n, g.xadj, g.adjncy, seed=3, device="cpu")
    order = (tO.reduced_nd(g, "eco", seed=3, device="cpu")
             if entry == "reduced_nd"
             else tO.fast_reduced_nd(g, seed=3, device="cpu"))
    np.testing.assert_array_equal(inv[order], np.arange(g.n))
    rinv = getattr(rif, entry)(g.n, g.xadj, g.adjncy, seed=3)
    assert sorted(rinv) == sorted(inv)
