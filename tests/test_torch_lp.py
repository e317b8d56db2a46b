"""Port parity: label propagation (`repro_torch.core.lp`) against
`repro.core.lp`.  Both sides get the same random draws — the JAX package
draws them from its keys and the test hands them to the port — so capped
acceptance, k-way rounds and clustering must agree bit for bit."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import csr as rcsr
from repro.core import lp as rlp
from repro.io import generators as rgen

from repro_torch.core import csr as tcsr
from repro_torch.core import lp as tlp
from repro_torch.io import generators as tgen

CPU = torch.device("cpu")
T = torch.from_numpy


def _views(name, args, seed=1):
    ref_g = getattr(rgen, name)(*args, seed=seed)
    port_g = getattr(tgen, name)(*args, seed=seed)
    return ref_g, rcsr.to_coo(ref_g), tcsr.to_coo(port_g, device=CPU)


def test_lexsort_matches_jnp_lexsort():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 3, 200)
    b = rng.integers(0, 4, 200).astype(np.float32)
    c = np.zeros(200, np.int32)
    for keys in ((b, a), (c, b, a), (c,)):
        want = np.asarray(jnp.lexsort(tuple(jnp.asarray(k) for k in keys)))
        got = tlp.lexsort(tuple(T(np.ascontiguousarray(k)) for k in keys))
        np.testing.assert_array_equal(got.numpy(), want)
    # the tie-by-index case checked by hand: a=[1,0,1,0,1], b=0
    got = tlp.lexsort((torch.zeros(5), torch.tensor([1, 0, 1, 0, 1])))
    assert got.tolist() == [1, 3, 0, 2, 4]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_capped_accept_bit_identical(seed):
    rng = np.random.default_rng(seed)
    n, k, b = 256, 5, 3
    vw = rng.integers(0, 4, n).astype(np.float32)
    labels = rng.integers(0, k, (b, n)).astype(np.int32)
    proposal = np.where(rng.random((b, n)) < 0.5,
                        rng.integers(0, k, (b, n)), labels).astype(np.int32)
    sizes = np.stack([np.bincount(l, vw, minlength=k) for l in labels]
                     ).astype(np.float32)
    cap = np.full(k, vw.sum() / k * 1.05, np.float32)
    # ties in priority exercise the by-index tie break
    pri = rng.integers(0, 6, (b, n)).astype(np.float32)
    got = tlp.capped_accept(T(labels), T(proposal), T(vw), T(sizes), T(cap),
                            T(pri)).numpy()
    for i in range(b):
        want = np.asarray(rlp.capped_accept(
            jnp.asarray(labels[i]), jnp.asarray(proposal[i]),
            jnp.asarray(vw), jnp.asarray(sizes[i]), jnp.asarray(cap),
            jnp.asarray(pri[i])))
        np.testing.assert_array_equal(got[i], want)
        inflow = np.bincount(got[i], np.where(got[i] != labels[i], vw, 0),
                             minlength=k)
        assert np.all((inflow == 0) | (sizes[i] + inflow <= cap))


def test_capped_accept_guarantee():
    """Port of test_partitioning.py::test_capped_accept_guarantee."""
    g = tgen.grid2d(16, 16)
    coo = tcsr.to_coo(g, device=CPU)
    n = coo.n_pad
    labels = torch.zeros(1, n, dtype=torch.int32)
    proposal = torch.ones(1, n, dtype=torch.int32)   # everyone wants block 1
    sizes = torch.tensor([[float(g.n), 0.0]])
    cap = torch.tensor([300.0, 50.0])
    pri = torch.arange(n, dtype=torch.float32)[None]
    out = tlp.capped_accept(labels, proposal, coo.vwgt, sizes, cap, pri)
    assert float(coo.vwgt[out[0] == 1].sum()) <= 50.0


@pytest.mark.parametrize("zero,force,localized", [
    (False, False, False), (True, False, True), (False, True, False)])
@pytest.mark.parametrize("k", [2, 4])
def test_kway_lp_round_bit_identical(k, zero, force, localized):
    ref_g, rcoo, tcoo = _views("weighted_grid", (12, 11))
    n = tcoo.n_pad
    rng = np.random.default_rng(k)
    b = 2
    labels = np.zeros((b, n), np.int32)
    labels[:, :ref_g.n] = rng.integers(0, k, (b, ref_g.n))
    vw = tcoo.vwgt.numpy()
    sizes = np.stack([np.bincount(l, vw, minlength=k) for l in labels]
                     ).astype(np.float32)
    # force needs an overweight block: tighten the cap under the sizes
    cap = np.full(k, vw.sum() / k * (0.98 if force else 1.1), np.float32)
    active = rng.random((b, n)) < 0.4 if localized else None
    keys = jax.random.split(jax.random.PRNGKey(k), b)
    parity = 1
    noise = np.stack([np.asarray(jax.random.uniform(
        keys[i], (n, k), jnp.float32, 0.0, rlp._NOISE)) for i in range(b)])
    got_l, got_s = tlp.kway_lp_round(
        tcoo, T(labels), T(sizes), T(cap), T(noise), k, parity,
        None if active is None else T(active),
        torch.full((b,), zero), torch.full((b,), force))
    moved = 0
    for i in range(b):
        want_l, want_s = rlp.kway_lp_round(
            rcoo, jnp.asarray(labels[i]), jnp.asarray(sizes[i]),
            jnp.asarray(cap), keys[i], k, jnp.int32(parity),
            None if active is None else jnp.asarray(active[i]), zero, force)
        np.testing.assert_array_equal(got_l[i].numpy(), np.asarray(want_l))
        np.testing.assert_array_equal(got_s[i].numpy(), np.asarray(want_s))
        moved += int((got_l[i].numpy() != labels[i]).sum())
    assert moved > 0


def test_kway_affinity_coo_matches_reference():
    ref_g, rcoo, tcoo = _views("barabasi_albert", (300, 3))
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 6, (2, tcoo.n_pad)).astype(np.int32)
    got = tlp.kway_affinity_coo(tcoo, T(labels), 6).numpy()
    for i in range(2):
        want = np.asarray(rlp.kway_affinity_coo(rcoo, jnp.asarray(labels[i]),
                                                6))
        np.testing.assert_array_equal(got[i], want)


def _cluster_noise(key, iters, e_pad):
    """The clustering loop's draws exactly as `_cluster_lp_jit` makes them."""
    rows = []
    for key_r in jax.random.split(key, iters):
        k1, _ = jax.random.split(key_r)
        rows.append(np.asarray(jax.random.uniform(
            k1, (e_pad,), jnp.float32, 0.0, rlp._NOISE)))
    return np.stack(rows)


@pytest.mark.parametrize("name,args,cap_w", [
    ("barabasi_albert", (400, 3), 12.0), ("grid2d", (16, 16), 6.0),
    ("weighted_grid", (10, 9), 4.0)])
def test_cluster_lp_bit_identical(name, args, cap_w):
    ref_g, rcoo, tcoo = _views(name, args)
    n, iters, seed = tcoo.n_pad, 6, 5
    key = jax.random.PRNGKey(seed)
    want, _ = rlp._cluster_lp_jit(
        rcoo, jnp.arange(n, dtype=jnp.int32),
        jnp.full((n,), cap_w, jnp.float32), key, iters)
    noise = _cluster_noise(key, iters, tcoo.e_pad)
    got = tlp.cluster_lp(tcoo, torch.arange(n, dtype=torch.int32),
                         torch.full((n,), cap_w), T(noise), iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sizes = np.bincount(got.numpy()[:ref_g.n], ref_g.vwgt)
    assert sizes.max() <= cap_w
    assert len(np.unique(got.numpy()[:ref_g.n])) < ref_g.n


def test_cluster_lp_padding_garbage_is_inert():
    """The live-edges-first sort: padding edges (w == 0) pointing
    anywhere leave every real vertex's cluster unchanged."""
    ref_g, _, tcoo = _views("barabasi_albert", (300, 3))
    n, e, iters = tcoo.n_pad, len(ref_g.adjncy), 5
    noise = T(_cluster_noise(jax.random.PRNGKey(2), iters, tcoo.e_pad))
    cap = torch.full((n,), 10.0)
    labels0 = torch.arange(n, dtype=torch.int32)
    clean = tlp.cluster_lp(tcoo, labels0, cap, noise, iters)
    rng = np.random.default_rng(4)
    src, dst = tcoo.src.clone(), tcoo.dst.clone()
    src[e:] = T(rng.integers(0, ref_g.n, tcoo.e_pad - e).astype(np.int32))
    dst[e:] = T(rng.integers(0, ref_g.n, tcoo.e_pad - e).astype(np.int32))
    dirty_coo = tcsr.CooGraph(src, dst, tcoo.w, tcoo.vwgt)
    dirty = tlp.cluster_lp(dirty_coo, labels0, cap, noise, iters)
    assert torch.equal(clean[:ref_g.n], dirty[:ref_g.n])


def test_size_constrained_lp_respects_cap():
    """Port of test_partitioning.py::test_size_constrained_lp_respects_cap
    (the port's own generator stream)."""
    g = tgen.barabasi_albert(600, 3, seed=7)
    clusters = tlp.size_constrained_lp(g, max_cluster_weight=20, iters=6,
                                       device="cpu")
    assert np.bincount(clusters).max() <= 20
    assert len(np.unique(clusters)) < g.n
    again = tlp.size_constrained_lp(g, max_cluster_weight=20, iters=6,
                                    device="cpu")
    np.testing.assert_array_equal(clusters, again)
