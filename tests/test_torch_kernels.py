"""Port parity: the block-affinity kernel's plain version (what
`repro_torch.kernels.ops.lp_affinity` runs on a CPU tensor) against the
JAX package's Pallas kernel in interpret mode, plus the wrapper's contract.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as rops

from repro_torch.kernels import lp_affinity as tlpk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the sweep of tests/test_kernels.py::test_lp_affinity_sweep, plus k = 3, 16
SHAPES = [(128, 8, 2), (256, 24, 5), (128, 16, 130), (384, 40, 17),
          (128, 8, 3), (256, 16, 16)]
BATCH = 3


def _inputs(n_pad, dmax, k, integer, seed=None):
    rng = np.random.default_rng(n_pad + dmax + k if seed is None else seed)
    nbr = rng.integers(0, n_pad, (n_pad, dmax)).astype(np.int32)
    live = rng.random((n_pad, dmax)) > 0.3
    w = rng.integers(1, 10, (n_pad, dmax)) if integer \
        else rng.random((n_pad, dmax))
    wgt = (w * live).astype(np.float32)
    labels = rng.integers(0, k, (BATCH, n_pad)).astype(np.int32)
    return nbr, wgt, labels


def _reference(nbr, wgt, labels, k):
    """Per row: the JAX package's ops.lp_affinity through the Pallas
    kernel (interpret mode on the CPU, as tests/test_kernels.py runs it)."""
    return np.stack([np.asarray(rops.lp_affinity(
        jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(lab), k,
        use_pallas=True)) for lab in labels])


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n_pad,dmax,k", SHAPES)
def test_plain_version_matches_pallas(n_pad, dmax, k, integer):
    nbr, wgt, labels = _inputs(n_pad, dmax, k, integer)
    want = _reference(nbr, wgt, labels, k)
    for b in (1, BATCH):
        got = tops.lp_affinity(torch.from_numpy(nbr), torch.from_numpy(wgt),
                               torch.from_numpy(labels[:b]), k).numpy()
        assert got.shape == (b, n_pad, k) and got.dtype == np.float32
        if integer:   # integer sums are exact in any order
            np.testing.assert_array_equal(got, want[:b])
        else:         # the reference test's tolerance
            np.testing.assert_allclose(got, want[:b], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_pad,dmax,k", [(128, 8, 2), (384, 40, 17)])
def test_padding_contract_garbage_nbr_is_inert(n_pad, dmax, k):
    """Only wgt == 0 marks padding: any valid id in those slots leaves
    every output unchanged."""
    nbr, wgt, labels = _inputs(n_pad, dmax, k, integer=False)
    clean = tops.lp_affinity(torch.from_numpy(nbr), torch.from_numpy(wgt),
                             torch.from_numpy(labels), k)
    garbage = nbr.copy()
    pad = wgt == 0
    garbage[pad] = np.random.default_rng(9).integers(0, n_pad, pad.sum())
    dirty = tops.lp_affinity(torch.from_numpy(garbage),
                             torch.from_numpy(wgt),
                             torch.from_numpy(labels), k)
    assert torch.equal(clean, dirty)


def test_out_of_range_labels_hit_no_block():
    nbr = torch.tensor([[1, 2], [0, 2], [0, 1]], dtype=torch.int32)
    wgt = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    labels = torch.tensor([[0, 5, -1]], dtype=torch.int32)
    aff = tref.affinity_ref(nbr, wgt, labels, 2)
    want = torch.tensor([[[0.0, 0.0], [3.0, 0.0], [5.0, 0.0]]])
    assert torch.equal(aff, want)


def test_cuda_wrapper_refuses_cpu_tensors():
    nbr, wgt, labels = (torch.from_numpy(a)
                        for a in _inputs(128, 8, 2, integer=True))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlpk.affinity_cuda(nbr, wgt, labels, 2)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")
    from repro_torch.core import interface
    from repro_torch.io.generators import grid2d
    g = grid2d(4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interface.kaffpa(g.n, None, g.xadj, None, g.adjncy, 2, 0.03)


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises and creates nothing."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(tlpk, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tlpk.build()
    assert not (tmp_path / "build").exists()


# one k in each register bucket (4, 8, 16, 32), one just above them and
# the sweep's k = 130 (shared-memory histogram, two class slices); dmax 40
# and 1024 take more than one staged chunk, and ops.lp_affinity pads dmax
# 6 to 8
CUDA_SHAPES = SHAPES + [(256, 8, 4), (256, 8, 8), (300, 8, 32),
                        (256, 16, 33), (128, 1024, 8), (200, 6, 16),
                        (128, 1024, 40)]


def test_cuda_kernel_matches_plain_version():
    """On the card only: the kernel against ``ref.affinity_ref`` at the
    sweep shapes and every k bucket, bit for bit on integer and on float
    weights (both add each sum's slots in the same order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the affinity kernel runs only there")
    dev = torch.device("cuda", 0)
    for (n_pad, dmax, k) in CUDA_SHAPES:
        for integer in (True, False):
            nbr, wgt, labels = (torch.from_numpy(a).to(dev) for a in
                                _inputs(n_pad, dmax, k, integer))
            for b in (1, BATCH):
                got = tops.lp_affinity(nbr, wgt, labels[:b], k)
                want = tref.affinity_ref(nbr, wgt, labels[:b], k)
                assert torch.equal(got, want), (n_pad, dmax, k, integer, b)


def test_kernel_source_exports_the_bound_symbol():
    src = tlpk.SOURCE.read_text()
    assert 'extern "C" int lp_affinity_launch(' in src
    assert "sm_90a" in " ".join(tlpk.NVCC_FLAGS)
