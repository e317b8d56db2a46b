"""Port parity: the pin-count kernel's plain version (what
`repro_torch.kernels.ops.pin_count` runs on a CPU tensor) against the JAX
package's Pallas kernel in interpret mode, plus the wrapper's contract and
the shared build plumbing.  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.hypergraph import container as rC
from repro.io import generators as rgen
from repro.kernels import ops as rops

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
    assert "sm_90a" in " ".join(tbuild.NVCC_FLAGS)
