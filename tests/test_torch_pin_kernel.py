"""Port parity: the pin-count kernel's plain versions (what
`repro_torch.kernels.ops.pin_count` and ``ops.pin_count_csr`` run on a CPU
tensor) against the JAX package's Pallas kernel in interpret mode, plus
the wrappers' contracts and the shared build plumbing.  The CSR entry
reads the port's pin list (``PinCoo``: pins in net order and the net
offsets), the Pallas kernel the reference's ELL-H view of the same
hypergraph.  The CUDA kernel itself is held against the plain versions on
the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.hypergraph import container as rC
from repro.io import generators as rgen
from repro.kernels import ops as rops

from repro_torch.core.hypergraph import container as tC
from repro_torch.io import generators as tgen
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pin_affinity as tpink
from repro_torch.kernels import ref as tref

# the sweep of tests/test_hypergraph.py::test_pin_affinity_kernel_bit_exact,
# plus the main path's k = 8
SHAPES = [(100, 150, 2), (300, 500, 5), (64, 90, 130), (200, 260, 8)]
BATCH = 3


def _inputs(n, m, k, integer, seed=None):
    """The reference's ELL-H view of a random hypergraph, with 0/1 masks
    or (``integer=False``) float masks on the real slots."""
    hg = rgen.random_hypergraph(n, m, seed=n + k, wmax=4)
    ell = rC.to_ell_h(hg)
    rng = np.random.default_rng(k if seed is None else seed)
    pins = np.array(ell.pins)
    mask = np.array(ell.pin_mask)
    if not integer:
        mask *= rng.random(mask.shape).astype(np.float32)
    labels = rng.integers(0, k, (BATCH, ell.n_pad)).astype(np.int32)
    return np.array(ell.vnets), pins, mask, np.array(ell.netw), labels, hg


def _reference(pins, mask, netw, labels, k):
    """Per row: the JAX package's ops.pin_count through the Pallas kernel
    (interpret mode on the CPU, as tests/test_hypergraph.py runs it)."""
    outs = [rops.pin_count(jnp.asarray(pins), jnp.asarray(mask),
                           jnp.asarray(netw), jnp.asarray(lab), k,
                           use_pallas=True) for lab in labels]
    return (np.stack([np.asarray(c) for c, _ in outs]),
            np.stack([np.asarray(s) for _, s in outs]))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,m,k", SHAPES)
def test_plain_version_matches_pallas(n, m, k, integer):
    _, pins, mask, netw, labels, _ = _inputs(n, m, k, integer)
    want_cnt, want_score = _reference(pins, mask, netw, labels, k)
    T = torch.from_numpy
    for b in (1, BATCH):
        cnt, score = tops.pin_count(T(pins), T(mask), T(netw),
                                    T(labels[:b]), k)
        assert cnt.shape == score.shape == (b, pins.shape[0], k)
        assert cnt.dtype == score.dtype == torch.float32
        if integer:   # integer counts are exact in any order
            np.testing.assert_array_equal(cnt.numpy(), want_cnt[:b])
            np.testing.assert_array_equal(score.numpy(), want_score[:b])
        else:         # float masks: summation order may differ
            np.testing.assert_allclose(cnt.numpy(), want_cnt[:b],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(score.numpy(), want_score[:b],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m,k", [(100, 150, 2), (300, 500, 5)])
def test_pin_affinity_matches_pallas_and_brute_force(n, m, k):
    vnets, pins, mask, netw, labels, hg = _inputs(n, m, k, integer=True)
    T = torch.from_numpy
    aff = tops.pin_affinity(T(vnets), T(pins), T(mask), T(netw), T(labels),
                            k).numpy()
    assert aff.shape == (BATCH, vnets.shape[0], k)
    np.testing.assert_array_equal(
        aff, tref.pin_affinity_ref(T(vnets), T(pins), T(mask), T(netw),
                                   T(labels), k).numpy())
    for b, lab in enumerate(labels):
        want = rops.pin_affinity(jnp.asarray(vnets), jnp.asarray(pins),
                                 jnp.asarray(mask), jnp.asarray(netw),
                                 jnp.asarray(lab), k, use_pallas=True)
        np.testing.assert_array_equal(aff[b], np.asarray(want))
        brute = np.zeros((hg.n, k))
        for e in range(hg.m):
            p = hg.net_pins(e)
            for c in range(k):
                brute[p, c] += int(hg.ewgt[e]) * int((lab[p] == c).sum())
        np.testing.assert_array_equal(aff[b, :hg.n], brute)


@pytest.mark.parametrize("n,m,k", [(100, 150, 2), (64, 90, 130)])
def test_padding_contract_garbage_pins_are_inert(n, m, k):
    """Only pin_mask == 0 marks padding: any valid id in those slots
    leaves every output unchanged."""
    vnets, pins, mask, netw, labels, _ = _inputs(n, m, k, integer=False)
    T = torch.from_numpy
    n_pad = vnets.shape[0]
    garbage = pins.copy()
    pad = mask == 0
    garbage[pad] = np.random.default_rng(9).integers(0, n_pad, pad.sum())
    clean = tops.pin_count(T(pins), T(mask), T(netw), T(labels), k)
    dirty = tops.pin_count(T(garbage), T(mask), T(netw), T(labels), k)
    assert all(torch.equal(a, b) for a, b in zip(clean, dirty))
    assert set(tops.PADDING_CONTRACT["pin_count"]["garbage"]) == {"pins"}


def test_out_of_range_labels_hit_no_block():
    pins = torch.tensor([[0, 1, 2], [1, 2, 0]], dtype=torch.int32)
    mask = torch.tensor([[1.0, 1.0, 1.0], [0.5, 1.0, 0.0]])
    netw = torch.tensor([2.0, 3.0])
    labels = torch.tensor([[0, 5, -1], [1, 1, 0]], dtype=torch.int32)
    cnt, score = tref.pin_count_ref(pins, mask, netw, labels, 2)
    want = torch.tensor([[[1.0, 0.0], [0.0, 0.0]],
                         [[1.0, 2.0], [1.0, 0.5]]])
    assert torch.equal(cnt, want)
    assert torch.equal(score, want * netw[None, :, None])


def _skewed(mod):
    """60 small nets and one of 4100 pins (over the 4096 of a real netlist's
    largest nets) on 5000 vertices, built by ``mod``'s Hypergraph."""
    rng = np.random.default_rng(5)
    nets = [rng.choice(5000, int(s), replace=False)
            for s in rng.integers(1, 12, 60)]
    nets.insert(30, rng.choice(5000, 4100, replace=False))
    return mod.Hypergraph.from_nets(5000, nets,
                                    ewgt=rng.integers(1, 5, len(nets)))


def _csr_case(shape, integer):
    """One hypergraph as the port's pin list and as the reference's ELL-H
    view, the same pin weights on both (0/1 with some zeros inside nets, or
    floats), and BATCH label rows: (eptr, pv, mask, pins, pin_mask, netw,
    labels, k)."""
    if shape == "skewed":
        ref_hg, port_hg, k = _skewed(rC), _skewed(tC), 8
    else:
        n, m, k = shape
        ref_hg = rgen.random_hypergraph(n, m, seed=n + k, wmax=4)
        port_hg = tgen.random_hypergraph(n, m, seed=n + k, wmax=4)
    hc = tC.to_pincoo(port_hg, device="cpu")
    ell = rC.to_ell_h(ref_hg)
    rng = np.random.default_rng(k)
    p = port_hg.pins
    w = ((rng.random(p) > 0.1) if integer else rng.random(p)).astype(
        np.float32)
    mask = hc.mask.numpy().copy()
    mask[:p] = w
    pin_mask = np.array(ell.pin_mask)
    pe = port_hg.pin_sources()
    pin_mask[pe, np.arange(p) - port_hg.eptr[pe]] = w
    labels = rng.integers(0, k, (BATCH, hc.n_pad)).astype(np.int32)
    return (hc.eptr, hc.pv, torch.from_numpy(mask), np.array(ell.pins),
            pin_mask, np.array(ell.netw), labels, k)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("shape", SHAPES + ["skewed"])
def test_csr_plain_version_matches_pallas(shape, integer):
    """The CSR entry's counts equal the Pallas kernel's cnt on the ELL-H
    view: exactly for 0/1 weights, within 1e-5 for floats (the Pallas
    kernel sums each chunk of slots in its own order)."""
    eptr, pv, mask, pins, pin_mask, netw, labels, k = _csr_case(shape,
                                                                integer)
    want, _ = _reference(pins, pin_mask, netw, labels, k)
    for b in (1, BATCH):
        cnt = tops.pin_count_csr(eptr, pv, mask, torch.from_numpy(
            labels[:b]), k)
        assert cnt.shape == (b, eptr.numel() - 1, k)
        assert cnt.dtype == torch.float32
        if integer:
            np.testing.assert_array_equal(cnt.numpy(), want[:b])
        else:
            np.testing.assert_allclose(cnt.numpy(), want[:b], rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES + ["skewed"])
def test_csr_and_ell_plain_versions_agree_bit_for_bit(shape):
    """Both plain versions add a net's pins in rank order, so on the same
    float weights the CSR one equals the ELL one bit for bit: what lets the
    card hold the CSR kernel to its plain version exactly."""
    eptr, pv, mask, pins, pin_mask, netw, labels, k = _csr_case(
        shape, integer=False)
    T = torch.from_numpy
    want, _ = tref.pin_count_ref(T(pins), T(pin_mask), T(netw), T(labels), k)
    assert torch.equal(tref.pin_count_csr_ref(eptr, pv, mask, T(labels), k),
                       want)


@pytest.mark.parametrize("shape", [(100, 150, 2), (64, 90, 130)])
def test_csr_garbage_past_eptr_is_inert(shape):
    """Pins past eptr[-1] lie in no net: any ids (even out of range) and
    weights there leave the counts unchanged."""
    eptr, pv, mask, *_, labels, k = _csr_case(shape, integer=False)
    labels = torch.from_numpy(labels)
    rng = np.random.default_rng(9)
    p, extra = int(eptr[-1]), pv.numel() - int(eptr[-1]) + 64
    dirty_pv = torch.cat([pv[:p], torch.from_numpy(
        rng.integers(-10**6, 10**6, extra).astype(np.int32))])
    dirty_mask = torch.cat([mask[:p], torch.from_numpy(
        rng.random(extra).astype(np.float32))])
    assert torch.equal(tops.pin_count_csr(eptr, pv, mask, labels, k),
                       tops.pin_count_csr(eptr, dirty_pv, dirty_mask,
                                          labels, k))
    assert tops.PADDING_CONTRACT["pin_count_csr"] == {"mask": "mask",
                                                      "garbage": ("pv",)}


def test_csr_out_of_range_labels_hit_no_block():
    eptr = torch.tensor([0, 3, 5, 5], dtype=torch.int32)
    pv = torch.tensor([0, 1, 2, 1, 2, 9], dtype=torch.int32)  # 9: no net's
    mask = torch.tensor([1.0, 1.0, 1.0, 0.5, 1.0, 7.0])
    labels = torch.tensor([[0, 5, -1], [1, 1, 0]], dtype=torch.int32)
    want = torch.tensor([[[1.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
                         [[1.0, 2.0], [1.0, 0.5], [0.0, 0.0]]])
    assert torch.equal(tref.pin_count_csr_ref(eptr, pv, mask, labels, 2),
                       want)
    assert torch.equal(tops.pin_count_csr(eptr, pv, mask, labels, 2), want)
    # the same nets as an ELL: the two plain versions agree
    pins = torch.tensor([[0, 1, 2], [1, 2, 0], [0, 0, 0]], dtype=torch.int32)
    pin_mask = torch.tensor([[1.0, 1.0, 1.0], [0.5, 1.0, 0.0], [0.0] * 3])
    cnt, _ = tref.pin_count_ref(pins, pin_mask, torch.ones(3), labels, 2)
    assert torch.equal(cnt, want)


def _malformed(case, eptr, pv, mask, labels):
    """One malformed argument of the CSR entry (name, args)."""
    bad = eptr.clone()
    if case == "eptr_int64":
        eptr = eptr.long()
    elif case == "eptr_2d":
        eptr = eptr[None]
    elif case == "eptr_empty":
        eptr = eptr[:0]
    elif case == "eptr_strided":
        eptr = eptr.repeat_interleave(2)[::2]
    elif case == "eptr_past_pins":
        bad[-1] = pv.numel() + 1
        eptr = bad
    elif case == "eptr_negative":
        bad[0] = -1
        eptr = bad
    elif case == "eptr_falls":     # ends in range, one offset out of order
        bad[len(bad) // 2] = pv.numel() + 1
        eptr = bad
    elif case == "mask_short":
        mask = mask[:-1]
    elif case == "labels_1d":
        labels = labels[0]
    return eptr, pv, mask, labels


MALFORMED = ["eptr_int64", "eptr_2d", "eptr_empty", "eptr_strided",
             "eptr_past_pins", "eptr_negative", "eptr_falls", "mask_short",
             "labels_1d"]


@pytest.mark.parametrize("case", ["cpu_tensors"] + MALFORMED)
def test_csr_cuda_wrapper_refuses(case):
    """The CUDA entry refuses CPU tensors; its input check (the one it runs
    before a launch) refuses a malformed eptr, pv, mask or labels."""
    eptr, pv, mask, *_, labels, k = _csr_case((100, 150, 2), integer=True)
    labels = torch.from_numpy(labels)
    if case == "cpu_tensors":
        with pytest.raises(ValueError, match="CUDA tensors"):
            tpink.pin_count_csr_cuda(eptr, pv, mask, labels, k)
        tpink.check_csr(eptr, pv, mask, labels, k)   # well formed
        return
    with pytest.raises(ValueError):
        tpink.check_csr(*_malformed(case, eptr, pv, mask, labels), k)


def test_csr_offsets_are_checked_again_after_an_in_place_change():
    """The offsets are read on the host once per tensor and version: a
    second check of the same offsets passes without a read, and an
    in-place change to them (a new version) is read and refused."""
    eptr, pv, mask, *_, labels, k = _csr_case((100, 150, 2), integer=True)
    labels = torch.from_numpy(labels)
    tpink.check_csr(eptr, pv, mask, labels, k)
    assert id(eptr) in tpink._CHECKED_OFFSETS
    tpink.check_csr(eptr, pv, mask, labels, k)
    eptr[3] = -1
    with pytest.raises(ValueError, match="decreases"):
        tpink.check_csr(eptr, pv, mask, labels, k)
    with pytest.raises(ValueError, match="decreases"):
        tpink.check_csr(eptr.clone(), pv, mask, labels, k)


def test_cuda_wrapper_refuses_cpu_tensors():
    _, pins, mask, netw, labels, _ = _inputs(100, 150, 2, integer=True)
    T = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpink.pin_count_cuda(T(pins), T(mask), T(netw), T(labels), 2)


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without nvcc the shared build raises and creates nothing."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tpink.build()
    assert not (tmp_path / "build").exists()


def test_kernel_source_exports_the_bound_symbol():
    src = tpink.SOURCE.read_text()
    assert 'extern "C" int pin_count_launch(' in src
    assert 'extern "C" int pin_count_csr_launch(' in src
    assert "sm_90a" in " ".join(tbuild.NVCC_FLAGS)
