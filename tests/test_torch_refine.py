"""Port parity: k-way refinement (`repro_torch.core.refine`) against
`repro.core.refine`.  The scan gets the JAX package's per-round draws
(from its own ``_round_keys`` schedule), so it must agree bit for bit on
the kernel path and on the COO path."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import csr as rcsr
from repro.core import lp as rlp
from repro.core import refine as rref
from repro.io import generators as rgen

from repro_torch.core import csr as tcsr
from repro_torch.core import refine as tref
from repro_torch.core.initial import random_partition
from repro_torch.core.partition import edge_cut, is_feasible
from repro_torch.io import generators as tgen

CPU = torch.device("cpu")
T = torch.from_numpy


def _scan_inputs(k, b, rounds, seed=0, name="weighted_grid", args=(11, 12)):
    ref_g = getattr(rgen, name)(*args, seed=1)
    port_g = getattr(tgen, name)(*args, seed=1)
    rcoo = rcsr.to_coo(ref_g)
    n = rcoo.n_pad
    rng = np.random.default_rng(seed)
    labs = np.zeros((b, n), np.int32)
    labs[:, :ref_g.n] = rng.integers(0, k, (b, ref_g.n))
    cap = rref._caps_for(ref_g, k, 0.05).astype(np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), b))
    rkeys = np.stack([rref._round_keys(kk, rounds, rounds) for kk in keys])
    noise = np.stack([np.stack([np.asarray(jax.random.uniform(
        jnp.asarray(rk), (n, k), jnp.float32, 0.0, rlp._NOISE))
        for rk in row]) for row in rkeys])
    return ref_g, port_g, rcoo, labs, cap, rkeys, noise


def _ref_scan(rcoo, labs, cap, rkeys, nrounds, zero, force, active, k,
              rounds, ell=None, use_kernel=False):
    out, cut = rref._refine_scan_batch(
        rcoo, jnp.asarray(labs), jnp.asarray(cap), jnp.asarray(rkeys),
        jnp.asarray(nrounds, jnp.int32), jnp.asarray(zero),
        jnp.asarray(force), jnp.asarray(active), k, rounds, ell=ell,
        use_kernel=use_kernel)
    return np.asarray(out), np.asarray(cut)


def _port_scan(port_g, labs, cap, noise, nrounds, zero, force, active, k,
               rounds, use_kernel=False):
    coo = tcsr.to_coo(port_g, device=CPU)
    ell = tcsr.to_ell(port_g, row_tile=coo.n_pad, device=CPU) \
        if use_kernel else None
    out, cut = tref._refine_scan_batch(
        coo, T(labs), T(cap), T(noise), torch.as_tensor(nrounds),
        torch.as_tensor(zero), torch.as_tensor(force), torch.as_tensor(active),
        k, rounds, ell=ell)
    return out.numpy(), cut.numpy()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("k", [2, 4])
def test_refine_scan_bit_identical(k, use_kernel):
    b, rounds = 3, 6
    ref_g, port_g, rcoo, labs, cap, rkeys, noise = _scan_inputs(k, b, rounds)
    n = rcoo.n_pad
    nrounds = np.array([rounds, 4, rounds])
    zero = np.array([False, True, False])
    force = np.array([False, False, True])
    active = np.ones((b, n), bool)
    active[1] = np.random.default_rng(1).random(n) < 0.1   # localized row
    rell = rcsr.to_ell(ref_g, row_tile=n) if use_kernel else None
    want, want_cut = _ref_scan(rcoo, labs, cap, rkeys, nrounds, zero, force,
                               active, k, rounds, rell, use_kernel)
    got, got_cut = _port_scan(port_g, labs, cap, noise, nrounds, zero, force,
                              active, k, rounds, use_kernel)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_cut, want_cut)
    assert (got[:, :ref_g.n] != labs[:, :ref_g.n]).any()


def test_masked_rounds_are_noops():
    """Rounds past a row's ``nrounds`` change nothing: a 12-round schedule
    masked to 5 equals a 5-round scan, and mixed rows equal solo rows."""
    k, b = 3, 2
    _, port_g, _, labs, cap, _, noise = _scan_inputs(k, b, 12, seed=3)
    n = labs.shape[1]
    ones = np.ones((b, n), bool)
    z, f = np.zeros(b, bool), np.zeros(b, bool)
    short, _ = _port_scan(port_g, labs, cap, noise[:, :5].copy(), [5, 5], z,
                          f, ones, k, 5)
    masked, _ = _port_scan(port_g, labs, cap, noise, [5, 5], z, f, ones, k,
                           12)
    np.testing.assert_array_equal(short, masked)
    mixed, _ = _port_scan(port_g, labs, cap, noise, [5, 12], z, f, ones, k,
                          12)
    np.testing.assert_array_equal(mixed[0], short[0])
    full, _ = _port_scan(port_g, labs[1:], cap, noise[1:], [12], z[1:],
                         f[1:], ones[1:], k, 12)
    np.testing.assert_array_equal(mixed[1], full[0])


def test_row_result_independent_of_batch():
    g = tgen.grid2d(8, 13)
    parts = [random_partition(g, 4, seed=s) for s in range(3)]
    seeds = [tref.row_seed(2, 0)] * 3
    solo = [tref.refine_kway_batch(g, [p], 4, 0.05, rounds=5, seed=2,
                                   seeds=seeds[:1], device="cpu")[0]
            for p in parts]
    batch = tref.refine_kway_batch(g, parts, 4, 0.05, rounds=5, seed=2,
                                   seeds=seeds, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(solo, batch))
    # default seeds: row i's seed depends on (seed, i) alone
    two = tref.refine_kway_batch(g, parts[:2], 4, 0.05, rounds=5, seed=7,
                                 device="cpu")
    three = tref.refine_kway_batch(g, parts, 4, 0.05, rounds=5, seed=7,
                                   device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(two, three))
    one = tref.refine_kway(g, parts[0], 4, 0.05, rounds=5, seed=7,
                           device="cpu")
    np.testing.assert_array_equal(one, three[0])


def test_kernel_path_equals_coo_path():
    """Port of test_kernels.py::test_kernel_integrated_refinement_matches_jnp:
    integer affinities make the two paths agree exactly."""
    g = tgen.grid2d(12, 12)
    p0 = random_partition(g, 3, seed=0)
    a = tref.refine_kway(g, p0, 3, rounds=5, seed=2, use_kernel=False,
                         device="cpu")
    b = tref.refine_kway(g, p0, 3, rounds=5, seed=2, use_kernel=True,
                         device="cpu")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [2, 4, 7])
def test_refine_never_worsens(k):
    g = tgen.weighted_grid(16, 16, seed=3)
    p0 = random_partition(g, k, seed=k)
    p1 = tref.refine_kway(g, p0, k, rounds=10, seed=1, device="cpu")
    assert edge_cut(g, p1) < edge_cut(g, p0)
    assert is_feasible(g, p1, k, 0.03)
    p2 = tref.refine_kway(g, p1, k, rounds=6, seed=9, device="cpu")
    assert edge_cut(g, p2) <= edge_cut(g, p1)
    p3 = tref.multi_try_refine(g, p2, k, tries=2, rounds=6, seed=3,
                               device="cpu")
    assert edge_cut(g, p3) <= edge_cut(g, p2)


def test_force_balance_restores_feasibility():
    g = tgen.grid2d(10, 10)
    part = np.zeros(g.n, dtype=np.int64)
    part[:10] = 1                       # block 0 far over its cap
    out = tref.refine_kway(g, part, 2, 0.03, rounds=30, seed=1,
                           force_balance=True, device="cpu")
    assert is_feasible(g, out, 2, 0.03)


def test_flow_refine_matches_reference():
    ref_g = rgen.grid2d(14, 14)
    port_g = tgen.grid2d(14, 14)
    part = np.asarray(rref.refine_kway(
        ref_g, np.arange(ref_g.n) % 3, 3, rounds=4, seed=1))
    want = rref.flow_refine_all_pairs(ref_g, part, 3, 0.05)
    got = tref.flow_refine_all_pairs(port_g, part, 3, 0.05)
    np.testing.assert_array_equal(got, want)
    assert edge_cut(port_g, got) <= edge_cut(port_g, part)
