"""Port parity: edge partitioning (`repro_torch.core.edgepart`) and its
metrics against the JAX package.  The SPAC construction is a host copy and
must give the same arrays; the partition's replication factor is held to
the band: the sum over 3 seeds ≤ 1.15× the reference's."""
import numpy as np
import pytest
import torch

from repro.core import edgepart as rE
from repro.core import partition as rP
from repro.io import generators as rgen

from repro_torch.core import edgepart as tE
from repro_torch.core import partition as tP
from repro_torch.io import generators as tgen

BAND = 1.15
GRAPHS = [("grid2d", (7, 9)), ("barabasi_albert", (120, 3, 1)),
          ("weighted_grid", (6, 8))]


@pytest.mark.parametrize("name,args", GRAPHS, ids=[n for n, _ in GRAPHS])
def test_build_spac_matches_reference(name, args):
    rg, tg = getattr(rgen, name)(*args), getattr(tgen, name)(*args)
    for infinity in (1000, 7):
        rspac, resplit = rE.build_spac(rg, infinity)
        tspac, tesplit = tE.build_spac(tg, infinity)
        for f in ("xadj", "adjncy", "vwgt", "adjwgt"):
            np.testing.assert_array_equal(getattr(tspac, f),
                                          getattr(rspac, f))
        np.testing.assert_array_equal(tesplit, resplit)
        assert tspac.check(raise_on_error=False) == []


@pytest.mark.parametrize("k", [2, 5])
def test_edge_partition_metrics_match_reference(k):
    rg, tg = rgen.barabasi_albert(200, 3, seed=2), \
        tgen.barabasi_albert(200, 3, seed=2)
    for s in range(3):
        ep = np.random.default_rng(s).integers(0, k, tg.m)
        assert tP.edge_partition_metrics(tg, ep, k) == \
            rP.edge_partition_metrics(rg, ep, k)
        np.testing.assert_array_equal(tE.naive_edge_partition(tg, k, seed=s),
                                      rE.naive_edge_partition(rg, k, seed=s))


@pytest.mark.parametrize("name,args,k", [("grid2d", (12, 12), 4),
                                         ("barabasi_albert", (150, 3, 5), 3)],
                         ids=["grid", "ba"])
def test_replication_within_band_of_reference(name, args, k):
    rg, tg = getattr(rgen, name)(*args), getattr(tgen, name)(*args)
    ref_rep = port_rep = 0.0
    for s in (1, 2, 3):
        want = np.asarray(rE.edge_partition(rg, k, seed=s))
        got = tE.edge_partition(tg, k, seed=s, device="cpu")
        assert got.shape == (tg.m,) and got.min() >= 0 and got.max() < k
        ref_rep += rP.edge_partition_metrics(rg, want, k)["replication"]
        port_rep += tP.edge_partition_metrics(tg, got, k)["replication"]
    naive = tP.edge_partition_metrics(
        tg, tE.naive_edge_partition(tg, k), k)["replication"]
    assert port_rep <= BAND * ref_rep, (port_rep, ref_rep)
    assert port_rep < 3 * naive


def test_edge_partition_needs_a_device():
    g = tgen.grid2d(4, 4)
    medium, esplit = tE.spac_medium(g, device="cpu")
    assert medium.device.type == "cpu" and esplit.shape == (g.m, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tE.edge_partition(g, 2)
