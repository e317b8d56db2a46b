"""Port parity: hypergraph refinement and kahypar end to end.

The refinement scan gets the JAX package's own per-round draws
(``jax.random.split(key, rounds)``, then ``uniform(key_r, (n_pad, k_pad),
0, 1e-4)`` per row), so it must agree bit for bit with
``repro.core.hypergraph.refine._hyper_refine_scan_batch`` on the kernel
path and on the COO path, for both objectives: the port's kernel path
counts pins from its pin list (``ops.pin_count_csr``), the reference's
from its ELL-H view through the Pallas kernel.  The reference is
evaluated op by op (``jax.disable_jit``): compiled, XLA's fused evaluation
of ``rem − wtot + aff + noise`` rounds the noise-perturbed gains a few
ulps differently, which reorders equal-gain moves in the capped
acceptance (at k=2, 2 of 768 labels within 5 rounds).

End to end, the two packages draw their noise from different generators,
so single runs differ.  On hp400 the km1 of a run is heavy-tailed in both
packages: about one seed in nine lands a coarse hierarchy too heavy to
balance and a km1 several times the median (over seeds 1..400 at k=4,
46 such seeds in the reference and 47 in the port, means 139.4775 and
138.89: ``tools/quality_parity_cpu.py --program kahypar --seeds 400``).
A sum over a few seeds then measures which side drew the outliers.  So
over seeds 1..30 the band holds the median (the bulk) and the mean (the
tail's mass) within 1.15× of the reference's, and the count of outlier
seeds (km1 above twice the reference's median) to at most the
reference's + ``TAIL_MARGIN``; every port partition must be feasible."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import interface as rif
from repro.core.hypergraph import container as rC
from repro.core.hypergraph import driver as rD
from repro.core.hypergraph import refine as rR
from repro.io import generators as rgen

from repro_torch import obs
from repro_torch.core import interface as tif
from repro_torch.core import multilevel as tML
from repro_torch.core.hypergraph import container as tC
from repro_torch.core.hypergraph import driver as tD
from repro_torch.core.hypergraph import metrics as tM
from repro_torch.core.hypergraph import refine as tR
from repro_torch.core.hypergraph.initial import random_partition
from repro_torch.io import generators as tgen

CPU = torch.device("cpu")
T = torch.from_numpy
BAND = 1.15
TAIL_MARGIN = 3
HP400 = dict(n=400, m=600, blocks=4, seed=11)


def _scan_inputs(k, b, rounds, seed=0):
    ref_hg = rgen.planted_hypergraph(160, 240, blocks=4, seed=7, wmax=3)
    port_hg = tgen.planted_hypergraph(160, 240, blocks=4, seed=7, wmax=3)
    k_pad = rR.k_bucket(k)
    rhc = rC.to_pincoo(ref_hg)
    n = rhc.n_pad
    rng = np.random.default_rng(seed)
    labs = np.zeros((b, n), np.int32)
    labs[:, :ref_hg.n] = rng.integers(0, k, (b, ref_hg.n))
    cap = rR._pad_caps(rR._caps_for(ref_hg, k, 0.05), k_pad)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), b))
    noise = np.stack([np.stack([np.asarray(jax.random.uniform(
        kr, (n, k_pad), jnp.float32, 0.0, rR._NOISE))
        for kr in jax.random.split(jnp.asarray(key), rounds)])
        for key in keys])
    return ref_hg, port_hg, rhc, labs, cap, keys, noise, k_pad


def _port_scan(port_hg, labs, cap, noise, force, k_pad, rounds, objective,
               use_kernel, nrounds=None):
    hc = tC.to_pincoo(port_hg, device=CPU)
    out, obj = tR._hyper_refine_scan_batch(
        hc, T(labs), T(cap), T(noise), torch.as_tensor(force), k_pad, rounds,
        objective, use_kernel=use_kernel,
        nrounds=None if nrounds is None else torch.as_tensor(nrounds))
    return out.numpy(), obj.numpy()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("objective", ["km1", "cut"])
@pytest.mark.parametrize("k", [2, 3])
def test_hyper_refine_scan_bit_identical(k, objective, use_kernel):
    b, rounds = 3, 5
    ref_hg, port_hg, rhc, labs, cap, keys, noise, k_pad = _scan_inputs(
        k, b, rounds, seed=k)
    force = np.array([False, True, False])
    rell = rC.to_ell_h(ref_hg) if use_kernel else None
    with jax.disable_jit():
        want, want_obj = rR._hyper_refine_scan_batch(
            rhc, jnp.asarray(labs), jnp.asarray(cap), jnp.asarray(keys),
            jnp.asarray(force), k_pad, rounds, objective, use_kernel,
            ell=rell)
    got, got_obj = _port_scan(port_hg, labs, cap, noise, force, k_pad,
                              rounds, objective, use_kernel)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_obj, np.asarray(want_obj))
    assert (got[:, :port_hg.n] != labs[:, :port_hg.n]).any()
    assert got.max() < k                  # no vertex enters a fake block


def test_kernel_path_equals_coo_path():
    """Port of test_hypergraph.py::test_refinement_kernel_path_matches_coo:
    integer pin counts make the two paths agree exactly."""
    hg = tgen.planted_hypergraph(200, 300, blocks=4, seed=7)
    part0 = random_partition(hg, 4, seed=1)
    a = tR.refine_hypergraph(hg, part0, 4, rounds=6, seed=3,
                             use_kernel=False, device="cpu")
    b = tR.refine_hypergraph(hg, part0, 4, rounds=6, seed=3,
                             use_kernel=True, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert tM.connectivity(hg, a) < tM.connectivity(hg, part0)


def test_masked_rounds_are_noops():
    """Rounds past a row's ``nrounds`` change nothing: a 10-round schedule
    masked to 4 equals a 4-round scan, and mixed rows equal solo rows."""
    k, b = 3, 2
    _, port_hg, _, labs, cap, _, noise, k_pad = _scan_inputs(k, b, 10,
                                                             seed=4)
    force = np.zeros(b, bool)
    short, _ = _port_scan(port_hg, labs, cap, noise[:, :4].copy(), force,
                          k_pad, 4, "km1", False)
    masked, _ = _port_scan(port_hg, labs, cap, noise, force, k_pad, 10,
                           "km1", False, nrounds=[4, 4])
    np.testing.assert_array_equal(short, masked)
    mixed, _ = _port_scan(port_hg, labs, cap, noise, force, k_pad, 10,
                          "km1", False, nrounds=[4, 10])
    np.testing.assert_array_equal(mixed[0], short[0])
    full, _ = _port_scan(port_hg, labs[1:], cap, noise[1:], force[1:],
                         k_pad, 10, "km1", False)
    np.testing.assert_array_equal(mixed[1], full[0])


@pytest.mark.parametrize("objective", ["km1", "cut"])
def test_row_result_independent_of_batch(objective):
    """The port of test_bucketing.py::test_hyper_batch_floor_identity: a
    row's result depends on its own seed alone."""
    hg = tgen.random_hypergraph(60, 40, seed=5)
    parts = [np.arange(hg.n, dtype=np.int64) % 3,
             random_partition(hg, 3, seed=1), random_partition(hg, 3, seed=2)]
    seeds = [tR.row_seed(9, 0)] * 3
    solo = [tR.refine_hypergraph_batch(hg, [p], 3, 0.1, rounds=5,
                                       objective=objective, seeds=seeds[:1],
                                       device="cpu")[0] for p in parts]
    batch = tR.refine_hypergraph_batch(hg, parts, 3, 0.1, rounds=5,
                                       objective=objective, seeds=seeds,
                                       device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(solo, batch))
    one = tR.refine_hypergraph(hg, parts[0], 3, 0.1, rounds=5, seed=9,
                               objective=objective, device="cpu")
    two = tR.refine_hypergraph_batch(hg, parts[:2], 3, 0.1, rounds=5, seed=9,
                                     objective=objective, device="cpu")
    np.testing.assert_array_equal(one, two[0])


@pytest.mark.parametrize("objective", ["km1", "cut"])
def test_vcycles_never_worsen(objective):
    """Port of test_multilevel.py::test_vcycle_non_worsening_hypergraph."""
    hg = tgen.planted_hypergraph(200, 300, blocks=4, seed=7)
    medium = tD.HypergraphMedium(hg, tD.PRESETS["eco"], objective,
                                 device="cpu")
    part = tML.multilevel(medium, 4, 0.03, seed=2)
    obj = medium.objective(part)
    for cyc in range(3):
        part = tML.vcycle(medium, part, 4, 0.03, seed=11 + cyc)
        assert medium.objective(part) <= obj
        assert tM.is_feasible(hg, part, 4, 0.03)
        obj = medium.objective(part)


def test_view_builds_are_O_levels():
    medium = tD.HypergraphMedium(tgen.planted_hypergraph(200, 300, seed=7),
                                 tD.PRESETS["eco"], device="cpu")
    levels = tML.build_hierarchy(medium, 4, seed=0)
    before = tML.view_build_count()
    part_c = tML.initial_partition(levels[-1], 4, 0.03, seed=0)
    tML.uncoarsen(levels, part_c, 4, 0.03, seed=0)
    assert tML.view_build_count() - before <= len(levels)
    before = tML.view_build_count()
    tML.uncoarsen(levels, part_c, 4, 0.03, seed=1)
    assert tML.view_build_count() == before


@pytest.mark.parametrize("k", [4, 2])
def test_kahypar_within_band_of_reference(k):
    ref_hg = rgen.planted_hypergraph(**HP400)
    port_hg = tgen.planted_hypergraph(**HP400)
    ref_km1, port_km1 = [], []
    for s in range(1, 31):
        ref_km1.append(tM.connectivity(
            port_hg, rD.kahypar(ref_hg, k, 0.03, "eco", seed=s)))
        part = tD.kahypar(port_hg, k, 0.03, "eco", seed=s, device="cpu")
        assert tM.is_feasible(port_hg, part, k, 0.03), s
        port_km1.append(tM.connectivity(port_hg, part))
    ref_km1, port_km1 = np.asarray(ref_km1), np.asarray(port_km1)
    readings = (port_km1.tolist(), ref_km1.tolist())
    assert np.median(port_km1) <= BAND * np.median(ref_km1), readings
    assert port_km1.mean() <= BAND * ref_km1.mean(), readings
    tail = 2 * np.median(ref_km1)
    assert ((port_km1 > tail).sum()
            <= (ref_km1 > tail).sum() + TAIL_MARGIN), readings
    rnd = tM.connectivity(port_hg, random_partition(port_hg, k, seed=0))
    assert np.median(port_km1) * 2 <= rnd


def test_kahypar_cut_objective():
    """Port of test_hypergraph.py::test_kahypar_cut_objective."""
    hg = tgen.planted_hypergraph(300, 450, blocks=4, seed=13)
    part = tD.kahypar(hg, 4, 0.03, "fast", seed=2, objective="cut",
                      device="cpu")
    assert tM.is_feasible(hg, part, 4, 0.03)
    assert tM.cut_net(hg, part) < tM.cut_net(hg, random_partition(hg, 4,
                                                                 seed=0))


@pytest.mark.parametrize("mode,objective", [(tif.FAST, "km1"),
                                            (tif.STRONGSOCIAL, "cut")])
def test_interface_kahypar(mode, objective):
    hg = tgen.planted_hypergraph(200, 300, blocks=4, seed=17)
    rec = obs.Recorder("kahypar")
    objval, part = tif.kahypar(hg.n, hg.m, None, None, hg.eptr, hg.eind, 4,
                               0.03, seed=1, mode=mode, objective=objective,
                               report=rec, device="cpu")
    score = tM.connectivity if objective == "km1" else tM.cut_net
    assert objval == score(hg, part)
    assert tM.is_feasible(hg, part, 4, 0.03)
    assert rec.counters()["engine/levels"] >= 2
    assert "kernels/pin_count/launches" not in rec.counters()  # CPU: plain
    ref_obj, _ = rif.kahypar(hg.n, hg.m, None, None, hg.eptr, hg.eind, 4,
                             0.03, seed=1, mode=mode, objective=objective)
    assert objval <= 2 * ref_obj


def test_kahypar_edge_cases():
    hg = tgen.grid_hypergraph(6, 6)
    assert not tD.kahypar(hg, 1, device="cpu").any()
    p0 = random_partition(hg, 2, seed=1)
    p1 = tD.kahypar(hg, 2, 0.03, "fast", seed=1, input_partition=p0,
                    device="cpu")
    assert tM.connectivity(hg, p1) <= tM.connectivity(hg, p0)
    with pytest.raises(ValueError, match="objective"):
        tD.kahypar(hg, 2, objective="soed", device="cpu")


def test_kernel_path_equals_plain_path_end_to_end():
    """What chip_smoke.py checks on the card: the kernel path and the
    plain path give the identical partition (integer pin counts)."""
    hg = tgen.planted_hypergraph(300, 450, blocks=4, seed=3)
    parts = []
    for use_kernel in (True, False):
        cfg = dataclasses.replace(tD.PRESETS["eco"], use_kernel=use_kernel)
        parts.append(tML.run(tD.HypergraphMedium(hg, cfg, device="cpu"), 4,
                             0.03, 1))
    np.testing.assert_array_equal(parts[0], parts[1])


@pytest.mark.parametrize("objective", ["km1", "cut"])
def test_kernel_path_builds_no_ell_view(monkeypatch, objective):
    """The kernel path reads the pin list: a kahypar run on it never builds
    an ELL-H view, and every pin count comes from ``ops.pin_count_csr``."""
    from repro_torch.core import hypergraph as tH
    from repro_torch.kernels import ops as tops

    def refuse(*args, **kwargs):
        raise AssertionError("to_ell_h called on the kernel path")

    monkeypatch.setattr(tC, "to_ell_h", refuse)
    monkeypatch.setattr(tH, "to_ell_h", refuse)
    calls = []
    real = tops.pin_count_csr

    def counted(*args):
        calls.append(args[3].shape)
        return real(*args)

    monkeypatch.setattr(tops, "pin_count_csr", counted)
    hg = tgen.planted_hypergraph(200, 300, blocks=4, seed=7)
    cfg = dataclasses.replace(tD.PRESETS["eco"], use_kernel=True)
    part = tML.run(tD.HypergraphMedium(hg, cfg, objective, device="cpu"),
                   4, 0.03, 1)
    assert tM.is_feasible(hg, part, 4, 0.03)
    assert calls


def test_device_none_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    hg = tgen.grid_hypergraph(4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tif.kahypar(hg.n, hg.m, None, None, hg.eptr, hg.eind, 2, 0.03)
