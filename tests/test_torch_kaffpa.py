"""The slice as a whole: `repro_torch`'s kaffpa end to end on the CPU,
held against `repro.core.interface.kaffpa`.  The two packages draw their
tie-break noise from different generators, so single runs differ (most
seeds give identical cuts; the rest scatter both ways).  The band of
tests/test_multilevel.py — cut ≤ 1.15× the reference's — is therefore
held on the summed cut of three consecutive seeds from each cell's own,
and every port partition must be feasible."""
import dataclasses

import numpy as np
import pytest

from repro.core import interface as rif
from repro.core import kaffpa as rK
from repro.core import multilevel as rML
from repro.io import generators as rgen

from repro_torch import obs
from repro_torch.core import interface as tif
from repro_torch.core import kaffpa as tK
from repro_torch.core import multilevel as tML
from repro_torch.core.initial import random_partition
from repro_torch.core.partition import (balance, edge_cut, evaluate,
                                        is_feasible)
from repro_torch.io import generators as tgen

BAND = 1.15
DEEP = dict(coarsening="matching", refine_rounds=10, multi_try=2,
            initial_tries=4, contraction_stop_factor=2, stop_n_floor=8)


def _c_api(g):
    return g.n, None, g.xadj, None, g.adjncy


def _interface_cell(mode):
    def ref(g, k, seed):
        return rif.kaffpa(*_c_api(g), k, 0.03, seed=seed, mode=mode)[1]

    def port(g, k, seed):
        cut, part = tif.kaffpa(*_c_api(g), k, 0.03, seed=seed, mode=mode,
                               device="cpu")
        assert cut == edge_cut(g, part)
        return part
    return ref, port


def _deep_cell():
    """stop_n_floor=8 forces many more levels than any preset."""
    def ref(g, k, seed):
        return rML.run(rK.GraphMedium(g, rK.KaffpaConfig(**DEEP)), k, 0.03,
                       seed)

    def port(g, k, seed):
        return tML.run(tK.GraphMedium(g, tK.KaffpaConfig(**DEEP),
                                      device="cpu"), k, 0.03, seed)
    return ref, port


# the graph cells of BENCH_engine.json: (graph, k, seed, (ref, port))
CELLS = {
    "kaffpa_eco_grid32_k4": (("grid2d", (32, 32)), 4, 3,
                             _interface_cell(rif.ECO)),
    "kaffpa_strong_grid32_k4": (("grid2d", (32, 32)), 4, 3,
                                _interface_cell(rif.STRONG)),
    "kaffpa_ecosocial_ba2k_k8": (("barabasi_albert", (2048, 4, 1)), 8, 1,
                                 _interface_cell(rif.ECOSOCIAL)),
    "kaffpa_deep_grid32_k2": (("grid2d", (32, 32)), 2, 3, _deep_cell()),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_kaffpa_within_band_of_reference(cell):
    (name, args), k, seed, (ref, port) = CELLS[cell]
    ref_g, port_g = getattr(rgen, name)(*args), getattr(tgen, name)(*args)
    ref_cut = port_cut = 0
    for s in (seed, seed + 1, seed + 2):
        ref_cut += edge_cut(port_g, ref(ref_g, k, s))
        part = port(port_g, k, s)
        assert is_feasible(port_g, part, k, 0.03), s
        port_cut += edge_cut(port_g, part)
    assert port_cut <= ref_cut * BAND, (port_cut, ref_cut)


@pytest.mark.parametrize("preset", list(tK.PRESETS))
def test_presets_feasible(preset):
    """Port of test_partitioning.py::test_kaffpa_presets_feasible."""
    g = (tgen.barabasi_albert(600, 3, seed=7) if "social" in preset
         else tgen.grid2d(16, 16))
    part = tK.kaffpa(g, 4, 0.03, preset, seed=2, device="cpu")
    ev = evaluate(g, part, 4)
    assert ev["feasible"], ev
    assert 0 < ev["cut"] < edge_cut(g, random_partition(g, 4, seed=0)) * 0.8


def test_vcycles_never_worsen():
    """Port of test_multilevel.py::test_vcycle_non_worsening_graph."""
    g = tgen.grid2d(24, 24)
    medium = tK.GraphMedium(g, tK.PRESETS["eco"], device="cpu")
    part = tML.multilevel(medium, 4, 0.03, seed=2)
    cut = edge_cut(g, part)
    for cyc in range(3):
        part = tML.vcycle(medium, part, 4, 0.03, seed=11 + cyc)
        assert edge_cut(g, part) <= cut
        assert is_feasible(g, part, 4, 0.03)
        cut = edge_cut(g, part)


def test_view_builds_are_O_levels():
    """Port of test_multilevel.py::test_view_builds_are_O_levels_not_..."""
    medium = tK.GraphMedium(tgen.grid2d(24, 24), tK.PRESETS["eco"],
                            device="cpu")
    levels = tML.build_hierarchy(medium, 4, seed=0)
    before = tML.view_build_count()
    part_c = tML.initial_partition(levels[-1], 4, 0.03, seed=0)
    part = tML.uncoarsen(levels, part_c, 4, 0.03, seed=0)
    assert tML.view_build_count() - before <= len(levels)
    before = tML.view_build_count()
    part2 = tML.uncoarsen(levels, part_c, 4, 0.03, seed=1)
    assert tML.view_build_count() == before
    assert len(part) == medium.n and len(part2) == medium.n


def test_kernel_path_equals_plain_path_end_to_end():
    """What chip_smoke.py checks on the card: the kernel path and the
    plain path give the identical partition (integer affinities)."""
    g = tgen.grid2d(20, 20)
    parts = []
    for use_kernel in (True, False):
        cfg = dataclasses.replace(tK.PRESETS["eco"], use_kernel=use_kernel)
        parts.append(tML.run(tK.GraphMedium(g, cfg, device="cpu"), 4, 0.03,
                             1))
    np.testing.assert_array_equal(parts[0], parts[1])


def test_kaffpa_balance_NE():
    g = tgen.grid2d(16, 16)
    cut, part = tif.kaffpa_balance_NE(*_c_api(g), 4, 0.05, seed=1,
                                      device="cpu")
    assert cut == edge_cut(g, part)
    assert balance(g.with_edge_balanced_weights(), part, 4) <= 1.05 + 1e-9


def test_interface_report_and_edge_cases():
    g = tgen.grid2d(16, 16)
    rec = obs.Recorder("kaffpa")
    cut, part = tif.kaffpa(*_c_api(g), 4, 0.03, seed=1, device="cpu",
                           report=rec)
    ctr = rec.counters()
    assert ctr["engine/levels"] >= 2 and ctr["engine/initial_tries"] == 4
    assert rec.trajectory("cycles") == [float(cut)]
    assert "kernels/lp_affinity/launches" not in ctr   # CPU: plain path
    _, one = tif.kaffpa(*_c_api(g), 1, 0.03, device="cpu")
    assert not one.any()
    p0 = random_partition(g, 4, seed=1)
    p1 = tK.kaffpa(g, 4, 0.03, "fast", seed=1, input_partition=p0,
                   device="cpu")
    assert edge_cut(g, p1) <= edge_cut(g, p0)
    p2 = tK.kaffpa(g, 4, 0.0, "fast", seed=1, enforce_balance=True,
                   device="cpu")
    assert is_feasible(g, p2, 4, 0.0)
