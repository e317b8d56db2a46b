"""The port's file formats and thin wrappers held against the JAX
package: the ParHIP binary graph (in memory and by the external-memory
converter) and the partition files are byte-identical to the
reference's, read back to the same arrays and refuse what the reference
refuses; `coarsen_level` and `project` are copied host code and equal
the reference's bit for bit; `kaffpa.vcycle` never returns a worse
partition and `kaffpa.multilevel_partition` stays inside the 1.15× band
of tests/test_multilevel.py over seeds 1–3."""
from pathlib import Path

import numpy as np
import pytest

from repro.core import coarsen as rC
from repro.core import kaffpa as rK
from repro.core.csr import GraphFormatError as RGraphFormatError
from repro.io import binio as rbin
from repro.io import generators as rgen
from repro.io import metis as rmetis

from repro_torch.core import coarsen as tC
from repro_torch.core import kaffpa as tK
from repro_torch.core.csr import Graph, GraphFormatError
from repro_torch.core.partition import edge_cut, is_feasible
from repro_torch.core.initial import random_partition
from repro_torch.io import binio as tbin
from repro_torch.io import generators as tgen
from repro_torch.io import metis as tmetis

BAND = 1.15
GRAPHS = {"grid": ("grid2d", (9, 7)),
          "ba": ("barabasi_albert", (300, 3, 1)),
          "geometric": ("random_geometric", (200,))}


def _graphs(name):
    gen, args = GRAPHS[name]
    return getattr(tgen, gen)(*args), getattr(rgen, gen)(*args)


def _weighted(g):
    """``g`` with vertex and edge weights, so the Metis file carries both."""
    src = g.edge_sources()
    keep = src < g.adjncy
    rng = np.random.default_rng(g.n)
    return Graph.from_edges(g.n, src[keep], g.adjncy[keep],
                            rng.integers(1, 9, int(keep.sum())),
                            vwgt=rng.integers(1, 5, g.n))


def _same_graph(a, b):
    for name in ("xadj", "adjncy", "vwgt", "adjwgt"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_binary_files_byte_identical_to_reference(tmp_path, name):
    """random_geometric has isolated vertices (blank lines in the
    unweighted Metis file): the JAX package's external converter skips
    those lines and runs out of them, the port's reads them; its file
    equals the in-memory converter's."""
    g, rg = _graphs(name)
    _same_graph(g, rg)
    isolated = bool(np.any(np.diff(g.xadj) == 0))
    assert isolated == (name == "geometric")
    files = {}
    for pkg, (binio, metis, graph) in {"port": (tbin, tmetis, g),
                                       "ref": (rbin, rmetis, rg)}.items():
        binio.write_binary(graph, str(tmp_path / f"{pkg}.bin"))
        for w, gw in (("plain", graph), ("weighted", _weighted(g))):
            text = tmp_path / f"{pkg}-{w}.graph"
            tmetis.write_metis(gw, str(text))
            binio.graph2binary(str(text), str(tmp_path / f"{pkg}-{w}.g2b"))
            ext = str(tmp_path / f"{pkg}-{w}.ext")
            if pkg == "ref" and isolated and w == "plain":
                with pytest.raises(StopIteration):
                    binio.graph2binary_external(str(text), ext)
                Path(ext).write_bytes(
                    (tmp_path / f"port-{w}.ext").read_bytes())
            else:
                binio.graph2binary_external(str(text), ext)
        files[pkg] = {p.name[len(pkg):]: p.read_bytes()
                      for p in tmp_path.glob(f"{pkg}*")}
    assert files["port"] == files["ref"]
    assert files["port"][".bin"] == files["port"]["-plain.g2b"] == \
        files["port"]["-plain.ext"]
    assert files["port"]["-weighted.g2b"] == files["port"]["-weighted.ext"]
    back = tbin.read_binary(str(tmp_path / "port.bin"))
    _same_graph(back, rbin.read_binary(str(tmp_path / "port.bin")))
    np.testing.assert_array_equal(back.xadj, g.xadj)
    np.testing.assert_array_equal(back.adjncy, g.adjncy)
    assert back.check(raise_on_error=False) == []


def test_partition_files_byte_identical_to_reference(tmp_path):
    part = np.random.default_rng(0).integers(0, 16, 1000)
    for pkg, (binio, metis) in {"port": (tbin, tmetis),
                                "ref": (rbin, rmetis)}.items():
        metis.write_partition(part, str(tmp_path / f"{pkg}.txt"))
        binio.write_partition_binary(part, str(tmp_path / f"{pkg}.bin"))
    for ext in ("txt", "bin"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"ref.{ext}").read_bytes()
    got = tmetis.read_partition(str(tmp_path / "port.txt"))
    np.testing.assert_array_equal(got, rmetis.read_partition(
        str(tmp_path / "port.txt")))
    np.testing.assert_array_equal(got, part)
    got = tbin.read_partition_binary(str(tmp_path / "port.bin"))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, part)
    tmetis.write_partition([3], str(tmp_path / "one.txt"))
    assert tmetis.read_partition(str(tmp_path / "one.txt")).tolist() == [3]


@pytest.mark.parametrize("damage", ["version", "header", "offsets"])
def test_bad_binary_raises_where_the_reference_raises(tmp_path, damage):
    g, _ = _graphs("grid")
    path = tmp_path / "g.bin"
    tbin.write_binary(g, str(path))
    raw = bytearray(path.read_bytes())
    if damage == "version":
        raw[0] = 2
    elif damage == "header":
        raw = raw[:16]
    else:
        raw[24] = 8                 # off_0 no longer points past the header
    path.write_bytes(bytes(raw))
    with pytest.raises(GraphFormatError) as got:
        tbin.read_binary(str(path))
    with pytest.raises(RGraphFormatError) as want:
        rbin.read_binary(str(path))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("protect", [False, True])
def test_coarsen_level_matching_equals_reference(name, protect):
    g, rg = _graphs(name)
    forbidden = None
    if protect:
        part = np.random.default_rng(1).integers(0, 2, g.n)
        forbidden = part[g.edge_sources()] != part[g.adjncy]
    for seed in (1, 2):
        got = tC.coarsen_level(g, "matching", 6.0, seed, forbidden=forbidden)
        want = rC.coarsen_level(rg, "matching", 6.0, seed,
                                forbidden=forbidden)
        assert (got is None) == (want is None)
        if got is None:
            continue
        (coarse, cl), (rcoarse, rcl) = got, want
        _same_graph(coarse, rcoarse)
        np.testing.assert_array_equal(cl, rcl)
        labels = np.random.default_rng(seed).integers(0, 4, coarse.n)
        np.testing.assert_array_equal(tC.project(labels, cl),
                                      rC.project(labels, rcl))
        if forbidden is not None:   # a protected cut edge is never contracted
            assert not np.any(forbidden & (cl[g.edge_sources()]
                                           == cl[g.adjncy]))


def test_coarsen_level_stalls_and_rejects_a_mode():
    star = Graph.from_edges(40, np.zeros(39, np.int64), np.arange(1, 40))
    rstar = rgen.grid2d(1, 1).__class__.from_edges(
        40, np.zeros(39, np.int64), np.arange(1, 40))
    # one pair matches: 39 of 40 vertices are left (> 0.95 n)
    assert tC.coarsen_level(star, "matching", 100.0, 1) is None
    assert rC.coarsen_level(rstar, "matching", 100.0, 1) is None
    with pytest.raises(ValueError):
        tC.coarsen_level(star, "spectral", 100.0, 1)
    g, _ = _graphs("ba")
    coarse, cl = tC.coarsen_level(g, "lp", 8.0, 1, device="cpu")
    assert coarse.n < 0.95 * g.n and cl.max() == coarse.n - 1
    assert coarse.total_vwgt() == g.total_vwgt()


def test_vcycle_never_worse_than_its_input():
    g = tgen.grid2d(16, 16)
    cfg = tK.PRESETS["fast"]
    start = tK.kaffpa(g, 4, 0.03, "fast", seed=1, device="cpu")
    bad = random_partition(g, 4, seed=3)
    for part in (start, bad):
        for seed in (1, 2):
            out = tK.vcycle(g, part, 4, 0.03, cfg, seed, device="cpu")
            assert edge_cut(g, out) <= edge_cut(g, part)
            if is_feasible(g, part, 4, 0.03):
                assert is_feasible(g, out, 4, 0.03)


def test_multilevel_partition_within_band_of_reference():
    g, rg = tgen.grid2d(20, 20), rgen.grid2d(20, 20)
    ref_cut = port_cut = 0
    for seed in (1, 2, 3):
        part = tK.multilevel_partition(g, 4, 0.03, tK.PRESETS["eco"], seed,
                                       device="cpu")
        assert is_feasible(g, part, 4, 0.03), seed
        port_cut += edge_cut(g, part)
        ref_cut += edge_cut(g, rK.multilevel_partition(
            rg, 4, 0.03, rK.PRESETS["eco"], seed))
    assert port_cut <= BAND * ref_cut, (port_cut, ref_cut)
