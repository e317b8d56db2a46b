"""Port parity: node separators (`repro_torch.core.nodesep`,
`repro_torch.core.separator`, `ops.sep_affinity`, the separator IO)
against the JAX package.

Kernel sums and scans get the same inputs and the JAX package's own draws
and must agree bit for bit (integer vertex weights in f32: exact in any
order).  Host polishes are copies and must return the same arrays.  Whole
runs draw noise from different generators, so the separator weight is
held to the reference's band: the sum over 3 seeds ≤ 1.15× the
reference's, run in the same process.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import csr as rcsr
from repro.core import interface as rif
from repro.core import nodesep as rNS
from repro.core import separator as rS
from repro.core.nodesep import refine as rNR
from repro.io import generators as rgen
from repro.io import metis as rmetis

from repro_torch import obs
from repro_torch.core import csr as tcsr
from repro_torch.core import interface as tif
from repro_torch.core import lp as tlp
from repro_torch.core import multilevel as tML
from repro_torch.core import nodesep as tNS
from repro_torch.core import separator as tS
from repro_torch.core.nodesep import refine as tNR
from repro_torch.io import generators as tgen
from repro_torch.io import metis as tmetis
from repro_torch.kernels import ops

CPU = torch.device("cpu")
T = torch.from_numpy
BAND = 1.15


def _weighted(gen, name, args, seed=0, wmax=5):
    """A generator graph with random vertex weights in [1, wmax]."""
    g = getattr(gen, name)(*args)
    vw = np.random.default_rng(seed).integers(1, wmax + 1, g.n)
    return type(g)(g.xadj, g.adjncy, vw, g.adjwgt)


def _pair(name, args, seed=0):
    """The same vertex-weighted graph in both packages."""
    return _weighted(rgen, name, args, seed), _weighted(tgen, name, args, seed)


def _port_coo(rcoo):
    return tcsr.coo_from_arrays(rcoo.src, rcoo.dst, rcoo.w, rcoo.vwgt, CPU)


# -- the separator-gain contraction ------------------------------------------

@pytest.mark.parametrize("shape", [(12, 12), (16, 16)],
                         ids=["n<n_pad", "n==n_pad"])
def test_sep_affinity_matches_reference(shape):
    """ops.sep_affinity's plain version, bit for bit against the
    reference's COO oracle and its Pallas kernel (interpret mode).  At
    16x16 n == n_pad = 256, so the padding sentinel n_pad - 1 is a real
    vertex of weight > 0; the padding slots then hold garbage ids, which
    only the wgt > 0 gate keeps out."""
    rg, tg = _pair("grid2d", shape, seed=1)
    rcoo = rcsr.to_coo(rg)
    rell = rcsr.to_ell(rg, row_tile=rcoo.n_pad)
    n_pad = rcoo.n_pad
    assert (rg.n == n_pad) == (shape == (16, 16))
    rng = np.random.default_rng(2)
    nbr, wgt = np.array(rell.nbr), np.array(rell.wgt)
    pad = wgt == 0
    nbr[pad] = rng.integers(0, n_pad, int(pad.sum()))      # garbage ids
    rell = rcsr.EllGraph(jnp.asarray(nbr), rell.wgt, rell.vwgt)
    labels = np.zeros((3, n_pad), np.int32)
    labels[:, :rg.n] = rng.integers(0, 3, (3, rg.n))
    got = ops.sep_affinity(T(nbr), T(wgt), T(np.array(rell.vwgt)),
                           T(labels)).numpy()
    tell = tcsr.ell_from_arrays(nbr, wgt, rell.vwgt, CPU)
    np.testing.assert_array_equal(
        tNR.sep_affinity_ell(tell, T(labels)).numpy(), got)
    np.testing.assert_array_equal(
        tNR.sep_affinity_coo(_port_coo(rcoo), T(labels)).numpy(), got)
    for b in range(3):
        lab = jnp.asarray(labels[b])
        np.testing.assert_array_equal(
            got[b], np.asarray(rNR.sep_affinity_ell(rell, lab,
                                                    use_pallas=True)))
        np.testing.assert_array_equal(
            got[b], np.asarray(rNR.sep_affinity_coo(rcoo, lab)))
    assert ops.PADDING_CONTRACT["sep_affinity"] == {"mask": "wgt",
                                                   "garbage": ("nbr",)}


# -- the separator scan ------------------------------------------------------

def _scan_case(rounds=7, b=4):
    """Candidates on a vertex-weighted grid: row 0 a refined bisection's
    boundary lift (feasible), row 1 an overweight A (forced), rows 2.. a
    random 3-labelling and another forced one."""
    rg, tg = _pair("grid2d", (13, 14), seed=3)
    rcoo = rcsr.to_coo(rg)
    n_pad = rcoo.n_pad
    rng = np.random.default_rng(4)
    two = (np.arange(rg.n) % 14 >= 7).astype(np.int64)
    cands = [rNR.boundary_to_separator(rg, two)]
    heavy = np.zeros(rg.n, np.int64)
    heavy[:20] = 1
    cands.append(rNR.boundary_to_separator(rg, heavy))
    cands.append(rng.integers(0, 3, rg.n))
    cands.append(np.where(np.arange(rg.n) < 150, 0, 1))
    labs = np.zeros((b, n_pad), np.int32)
    for i, c in enumerate(cands[:b]):
        labs[i, :rg.n] = c
    force = np.asarray([not rNR.separator_is_feasible(rg, c, 0.1)
                        for c in cands[:b]])
    assert force.any() and not force.all()
    cap = rNR.separator_caps(rg, 0.1).astype(np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(5), b))
    noise = np.stack([np.stack([np.asarray(jax.random.uniform(
        kr, (n_pad,), jnp.float32, 0.0, rNR._NOISE))
        for kr in jax.random.split(jnp.asarray(k), rounds)]) for k in keys])
    return rg, tg, rcoo, labs, cap, keys, force, noise


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["coo", "kernel"])
def test_sep_refine_scan_bit_identical(use_kernel):
    """`_sep_refine_scan_batch` with the reference's per-round draws
    (uniform(split(key, rounds)[r], (n_pad,), 0, 1e-4)), mixed force rows:
    the port's kernel path and COO path both equal the reference exactly
    (labels and separator weights)."""
    rounds = 7
    rg, tg, rcoo, labs, cap, keys, force, noise = _scan_case(rounds)
    rell = rcsr.to_ell(rg, row_tile=rcoo.n_pad) if use_kernel else None
    want, want_w = rNR._sep_refine_scan_batch(
        rcoo, jnp.asarray(labs), jnp.asarray(cap), jnp.asarray(keys),
        jnp.asarray(force), rounds, ell=rell, use_kernel=use_kernel)
    coo = tcsr.to_coo(tg, device=CPU)
    ell = tcsr.to_ell(tg, row_tile=coo.n_pad, device=CPU) \
        if use_kernel else None
    got, got_w = tNR._sep_refine_scan_batch(
        coo, T(labs), T(cap), T(noise), T(force), rounds, ell=ell)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert (got.numpy() != labs).any()
    for row, lab in zip(got.numpy(), labs):      # the invariant is kept
        if tNR.separator_invariant_ok(tg, lab[:tg.n]):
            assert tNR.separator_invariant_ok(tg, row[:tg.n])


def test_capped_accept_row_caps():
    """(B, c) caps equal the shared (c,) form when the rows agree, and a
    row with its own caps equals a call with those caps alone."""
    rng = np.random.default_rng(6)
    b, n, c = 3, 200, 3
    labels = T(rng.integers(0, c, (b, n)).astype(np.int32))
    proposal = T(rng.integers(0, c, (b, n)).astype(np.int32))
    vw = T(rng.integers(1, 5, n).astype(np.float32))
    sizes = torch.zeros(b, c).scatter_add_(1, labels.long(),
                                           vw.expand(b, -1))
    pri = T(rng.random((b, n)).astype(np.float32))
    cap = T(np.asarray([250.0, 260.0, 240.0], np.float32))
    shared = tlp.capped_accept(labels, proposal, vw, sizes, cap, pri)
    rows = tlp.capped_accept(labels, proposal, vw, sizes,
                             cap.expand(b, -1), pri)
    assert torch.equal(shared, rows)
    caps = T(np.asarray([[250.0, 260.0, 240.0], [200.0, 300.0, 180.0],
                         [270.0, 230.0, 250.0]], np.float32))
    mixed = tlp.capped_accept(labels, proposal, vw, sizes, caps, pri)
    for i in range(b):
        solo = tlp.capped_accept(labels[i:i + 1], proposal[i:i + 1], vw,
                                 sizes[i:i + 1], caps[i], pri[i:i + 1])
        assert torch.equal(mixed[i:i + 1], solo)
    assert not torch.equal(mixed, shared)


def test_refine_separator_multi_equals_batch():
    """The wave's stacked-sibling refine: per graph, bit-identical to
    refine_separator_batch with that graph's seed."""
    graphs = [_weighted(tgen, "grid2d", a, seed=i)
              for i, a in enumerate([(10, 10), (9, 11), (8, 12)])]
    coos = [tcsr.to_coo(g, device=CPU) for g in graphs]
    assert len({(c.n_pad, c.e_pad) for c in coos}) == 1
    cands_lists = []
    for i, g in enumerate(graphs):
        rng = np.random.default_rng(i)
        cands = [tNR.boundary_to_separator(
            g, (rng.random(g.n) < 0.5).astype(np.int64)) for _ in range(2)]
        lop = np.zeros(g.n, np.int64)
        lop[:10] = 1                               # overweight A: forced
        cands.append(tNR.boundary_to_separator(g, lop))
        cands_lists.append(cands)
    seeds = [3, 8, 13]
    multi = tNR.refine_separator_multi(graphs, cands_lists, 0.1, rounds=6,
                                       seeds=seeds, coos=coos)
    for g, coo, cands, s, got in zip(graphs, coos, cands_lists, seeds,
                                     multi):
        want = tNR.refine_separator_batch(g, cands, 0.1, rounds=6, seed=s,
                                          coo=coo, use_kernel=False)
        assert len(got) == len(want) == len(cands)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # and the engine's wave equals one tournament per level
    media = [tNS.SeparatorMedium(g, tNS.PRESETS["fast"], device="cpu")
             for g in graphs]
    levels = [tML.Level(m, None) for m in media]
    wave = tML.initial_partition_wave(levels, 2, 0.2, seeds)
    for lv, s, got in zip(levels, seeds, wave):
        np.testing.assert_array_equal(
            got, tML.initial_partition(lv, 2, 0.2, s))


@pytest.mark.parametrize("case", range(6))
def test_invariant_every_step_every_level(case):
    """Port of test_property.py::test_nodesep_refinement_invariant_every_
    step_every_level: no A vertex is adjacent to a B vertex after every
    single-round refine step and every full per-level pipeline, at every
    level, on the kernel path (the CPU plain version) and the COO path."""
    rng = np.random.default_rng(case)
    n = int(rng.integers(8, 40))
    m = int(rng.integers(n, 3 * n))
    g = tcsr.Graph.from_edges(n, rng.integers(0, n, m), rng.integers(0, n, m),
                              rng.integers(1, 9, m))
    g = tcsr.Graph(g.xadj, g.adjncy, rng.integers(1, 4, n), g.adjwgt)
    cfg = tNS.NodesepConfig(refine_rounds=4, bisect_rounds=4,
                            initial_tries=2, stop_n_floor=4,
                            contraction_stop_factor=2,
                            use_kernel=bool(case % 2))
    medium = tNS.SeparatorMedium(g, cfg, device="cpu")
    levels = tML.build_hierarchy(medium, 2, case)
    assert len(levels) > 1 or n <= 8
    for level in levels:
        gm = level.medium
        cands = gm.initial_candidates(2, 0.2, case)
        for c in cands:
            assert tNR.separator_invariant_ok(gm.g, c)
        labels = cands[0]
        coo, ell, vw_nbr = gm.views
        assert (ell is not None) == cfg.use_kernel
        for step in range(3):      # single-round steps expose every state
            labels = tNR.refine_separator(gm.g, labels, 0.2, rounds=1,
                                          seed=case + step, coo=coo, ell=ell,
                                          vw_nbr=vw_nbr,
                                          use_kernel=gm.use_kernel)
            assert tNR.separator_invariant_ok(gm.g, labels)
        labels = gm.refine(labels, 2, 0.2, case)    # full per-level pipeline
        assert tNR.separator_invariant_ok(gm.g, labels)


# -- host polishes and the post-hoc construction ----------------------------

@pytest.mark.parametrize("name,args", [("grid2d", (14, 15)),
                                       ("barabasi_albert", (300, 3, 2))],
                         ids=["grid", "ba"])
def test_host_polishes_match_reference(name, args):
    rg, tg = _pair(name, args, seed=7)
    rng = np.random.default_rng(8)
    for trial in range(3):
        two = (rng.random(rg.n) < 0.5).astype(np.int64) if trial else \
            (np.arange(rg.n) < rg.n // 2).astype(np.int64)
        lab = tNR.boundary_to_separator(tg, two)
        np.testing.assert_array_equal(lab, rNR.boundary_to_separator(rg, two))
        for eps in (0.05, 0.3):
            np.testing.assert_array_equal(
                tNR.vertex_cover_polish(tg, lab, eps),
                rNR.vertex_cover_polish(rg, lab, eps))
            np.testing.assert_array_equal(
                tNR.flow_separator_polish(tg, lab, eps),
                rNR.flow_separator_polish(rg, lab, eps))
        np.testing.assert_array_equal(
            tS.separator_from_partition_pair(tg, two, 0, 1),
            rS.separator_from_partition_pair(rg, two, 0, 1))
        part4 = rng.integers(0, 4, rg.n)
        np.testing.assert_array_equal(
            tS.partition_to_vertex_separator(tg, part4, 4),
            rS.partition_to_vertex_separator(rg, part4, 4))
        sep, part = tNS.split_labels(lab)
        for s in (sep, sep[1:]):
            assert (tS.verify_separator(tg, part, s, 2)
                    == rS.verify_separator(rg, part, s, 2))
        assert tS.verify_separator(tg, part, sep, 2)


def test_verify_separator_rejects_non_disconnecting_sets():
    g = tcsr.Graph.from_edges(5, [0, 1, 2, 3], [1, 2, 3, 4])
    part = np.array([0, 0, 1, 1, 1])
    assert tS.verify_separator(g, part, np.array([1]), 2)
    assert not tS.verify_separator(g, part, np.array([3]), 2)
    assert not tS.verify_separator(g, part, np.zeros(0, dtype=np.int64), 2)


# -- the multilevel separator band ------------------------------------------

#: the BENCH_nodesep.json cells at eps = 0.2
CELLS = {"grid32": ("grid2d", (32, 32), {}),
         "ba1k": ("barabasi_albert", (1024, 4), {"seed": 3}),
         "geo1k": ("random_geometric", (1024,), {"seed": 5})}
SEEDS = (1, 2, 3)


@pytest.fixture(scope="module")
def reference_separators():
    """Separator weight of the reference's multilevel separator per cell,
    summed over SEEDS (run once for the module)."""
    out = {}
    for cell, (name, args, kw) in CELLS.items():
        rg = getattr(rgen, name)(*args, **kw)
        out[cell] = sum(len(rNS.multilevel_node_separator(
            rg, 0.2, "eco", seed=s)[0]) for s in SEEDS)
    return out


@pytest.mark.parametrize("cell", list(CELLS))
def test_separator_within_band_of_reference(cell, reference_separators):
    name, args, kw = CELLS[cell]
    g = getattr(tgen, name)(*args, **kw)
    total = 0
    for s in SEEDS:
        sep, part = tNS.multilevel_node_separator(g, 0.2, "eco", seed=s,
                                                  device="cpu")
        labels = part.copy()
        labels[sep] = tNS.SEP
        assert tNR.separator_is_feasible(g, labels, 0.2), s
        assert tNR.separator_invariant_ok(g, labels), s
        assert tS.verify_separator(g, part, sep, 2), s
        total += len(sep)                    # unit vertex weights
    assert total <= BAND * reference_separators[cell], (
        total, reference_separators[cell])


@pytest.mark.parametrize("cell", list(CELLS))
def test_kernel_path_equals_plain_path(cell):
    """What chip_smoke.py checks on the card: identical labels on the
    kernel path (ELL, the CPU plain version of the kernel) and the COO
    path, and the kernel path builds one ELL view per level."""
    name, args, kw = CELLS[cell]
    g = getattr(tgen, name)(*args, **kw)
    out = {}
    for use_kernel in (True, False):
        cfg = dataclasses.replace(tNS.PRESETS["eco"], use_kernel=use_kernel)
        rec = obs.Recorder("nodesep")
        builds = tcsr.metrics.get(tcsr.TO_ELL_BUILDS)
        out[use_kernel] = tML.run(tNS.SeparatorMedium(g, cfg, recorder=rec,
                                                      device="cpu"),
                                  2, 0.2, 1)
        ell_builds = tcsr.metrics.get(tcsr.TO_ELL_BUILDS) - builds
        levels = rec.counters()["engine/levels"]
        assert ell_builds == (levels if use_kernel else 0), (ell_builds,
                                                              levels)
    np.testing.assert_array_equal(out[True], out[False])


# -- entry points, IO --------------------------------------------------------

def _c_api(g):
    return g.n, None, g.xadj, None, g.adjncy


def test_interface_node_separator():
    """nparts=2 multilevel (the default) and post-hoc, nparts=3 pairwise:
    each output is a separator of a partition that kaffpa or the engine
    found; the multilevel one within the band of the reference's entry.
    ``memetic=True`` runs the island driver: with ``time_limit=0`` the
    initial population only, whose first member is the multilevel run."""
    g = tgen.grid2d(16, 16)
    nums = {}
    for kw in ({}, {"multilevel": False}, {"nparts": 3}):
        kw = {"nparts": 2, **kw}
        num, sep = tif.node_separator(*_c_api(g), imbalance=0.2, seed=1,
                                      device="cpu", **kw)
        assert num == len(sep) > 0 and len(np.unique(sep)) == num
        in_sep = np.zeros(g.n, bool)
        in_sep[sep] = True
        rest, ids = g.subgraph(~in_sep)
        assert rest.m < g.m                       # S cut something
        nums[(kw["nparts"], kw.get("multilevel", True))] = num
    ref_num, _ = rif.node_separator(*_c_api(rgen.grid2d(16, 16)), 2, 0.2,
                                    seed=1)
    assert nums[(2, True)] <= BAND * ref_num, (nums, ref_num)
    num, sep = tif.node_separator(*_c_api(g), 2, 0.2, seed=1, memetic=True,
                                  time_limit=0, device="cpu")
    assert num == len(sep) > 0 and len(np.unique(sep)) == num
    assert num <= nums[(2, True)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tif.node_separator(*_c_api(g), 2, 0.2)


def test_separator_io_roundtrip_and_bytes(tmp_path):
    g = tgen.grid2d(16, 16)
    sep, part = tNS.multilevel_node_separator(g, 0.2, "fast", seed=1,
                                              device="cpu")
    p, q = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    tmetis.write_separator(part, sep, 2, p)
    rmetis.write_separator(part, sep, 2, q)
    assert open(p, "rb").read() == open(q, "rb").read()
    part2, sep2 = tmetis.read_separator(p, k=2)
    rpart2, rsep2 = rmetis.read_separator(p, k=2)
    np.testing.assert_array_equal(sep2, rsep2)
    np.testing.assert_array_equal(part2, rpart2)
    assert np.array_equal(np.sort(sep), np.sort(sep2))
    non_sep = np.setdiff1d(np.arange(g.n), sep)
    assert np.array_equal(part[non_sep], part2[non_sep])
    with pytest.raises(tcsr.GraphFormatError):
        tmetis.read_separator(p, k=1)
    tmetis.write_separator(part, np.zeros(0, dtype=np.int64), 2, p)
    part3, sep3 = tmetis.read_separator(p, k=2)
    assert len(sep3) == 0 and np.array_equal(part, part3)
