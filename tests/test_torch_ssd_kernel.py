"""Port parity: the SSD scan's plain version (what
`repro_torch.kernels.ops.ssd_scan` runs on a CPU tensor) against the JAX
package's Pallas kernel in interpret mode and its sequential oracle, the
port's chunked torch engines against the reference's, the padding
contract, and the CUDA wrapper's contract.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py`` and by the
card-only test below."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models import mamba2 as rM2

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import mamba2 as tM2

# the sweep of tests/test_kernels.py::test_ssd_scan_sweep (L = 200 is not a
# multiple of the chunk: the padding path)
SWEEP = [(2, 128, 8, 4, 64), (3, 256, 16, 8, 128), (1, 64, 32, 16, 32),
         (2, 200, 8, 8, 64)]


def _inputs(bh, l, p, n, seed=None):
    """The reference sweep's inputs, drawn as it draws them."""
    rng = np.random.default_rng(bh * l + p if seed is None else seed)
    x = rng.standard_normal((bh, l, p)).astype(np.float32)
    ld = (-0.05 - 0.5 * rng.random((bh, l))).astype(np.float32)
    b = (rng.standard_normal((bh, l, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bh, l, n)) * 0.3).astype(np.float32)
    return x, ld, b, c


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("bh,l,p,n,chunk", SWEEP)
def test_plain_version_matches_pallas_and_oracle(bh, l, p, n, chunk):
    ins = _inputs(bh, l, p, n)
    got = tops.ssd_scan(*(torch.from_numpy(a) for a in ins),
                        chunk=chunk).numpy()
    pallas = np.asarray(rops.ssd_scan(*(jnp.asarray(a) for a in ins),
                                      chunk=chunk))
    oracle = np.asarray(rref.ssd_scan_ref(*(jnp.asarray(a) for a in ins)))
    assert got.shape == (bh, l, p) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, oracle, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("bh,l,p,n,chunk", SWEEP + [(4, 192, 16, 8, 64)])
def test_ssd_chunked_matches_reference(bh, l, p, n, chunk):
    """f32 in another summation order: 1e-4 of max |y|."""
    ins = _inputs(bh, l, p, n)
    got = tM2.ssd_chunked(*(torch.from_numpy(a) for a in ins),
                          chunk=chunk).numpy()
    want = np.asarray(rM2.ssd_chunked(*(jnp.asarray(a) for a in ins),
                                      chunk=chunk))
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("bsz,h,l,p,n,chunk", [
    (2, 3, 128, 8, 4, 64), (1, 4, 200, 16, 8, 64), (2, 2, 96, 32, 16, 32)])
def test_ssd_chunked_grouped_matches_reference(bsz, h, l, p, n, chunk):
    rng = np.random.default_rng(bsz * h + l)
    x = rng.standard_normal((bsz, h, l, p)).astype(np.float32)
    ld = (-0.05 - 0.5 * rng.random((bsz, h, l))).astype(np.float32)
    b = (rng.standard_normal((bsz, l, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bsz, l, n)) * 0.3).astype(np.float32)
    ins = (x, ld, b, c)
    got = tM2.ssd_chunked_grouped(*(torch.from_numpy(a) for a in ins),
                                  chunk=chunk).numpy()
    want = np.asarray(rM2.ssd_chunked_grouped(
        *(jnp.asarray(a) for a in ins), chunk=chunk))
    assert got.shape == (bsz, h, l, p)
    assert _rel(got, want) < 1e-4
    # the grouped engine is the per-head one with B/C broadcast to heads
    flat = tM2.ssd_chunked(
        torch.from_numpy(x).reshape(bsz * h, l, p),
        torch.from_numpy(ld).reshape(bsz * h, l),
        *(torch.from_numpy(m)[:, None].expand(bsz, h, l, n)
          .reshape(bsz * h, l, n) for m in (b, c)), chunk=chunk)
    assert _rel(got, flat.reshape(bsz, h, l, p).numpy()) < 1e-5


@pytest.mark.parametrize("scan", ["ops", "chunked"])
def test_zero_tail_steps_are_inert(scan):
    """The PADDING_CONTRACT row: zero steps appended along L (log-decay
    0, b = x = 0) leave every real output unchanged, bit for bit — the
    chunk padding inside the call (200 → 256) and a whole extra chunk of
    zero steps outside it (→ 320)."""
    assert tops.PADDING_CONTRACT["ssd_scan"]["tail"] == (
        "x", "logdecay", "b", "c")
    x, ld, b, c = (torch.from_numpy(a) for a in _inputs(2, 200, 8, 8))
    fn = {"ops": tops.ssd_scan, "chunked": tM2.ssd_chunked}[scan]
    got = fn(x, ld, b, c, chunk=64)
    if scan == "ops":   # the sequential oracle on the unpadded steps
        assert torch.equal(got, tref.ssd_scan_ref(x, ld, b, c))
    tail = [torch.cat([t, t.new_zeros((t.shape[0], 120) + t.shape[2:])], 1)
            for t in (x, ld, b, c)]
    assert torch.equal(fn(*tail, chunk=64)[:, :200], got)


def test_ssd_scan_takes_any_n_and_p():
    """N and P that are not multiples of 4 (the kernel path pads them with
    zeros; the plain path takes them as they are) match the oracle."""
    ins = _inputs(2, 70, 6, 5, seed=3)
    got = tops.ssd_scan(*(torch.from_numpy(a) for a in ins), chunk=32)
    want = np.asarray(rref.ssd_scan_ref(*(jnp.asarray(a) for a in ins)))
    assert got.shape == (2, 70, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


def test_cuda_wrapper_refuses_cpu_tensors():
    x, ld, b, c = (torch.from_numpy(a) for a in _inputs(2, 128, 8, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tssd.ssd_scan_cuda(x, ld, b, c, chunk=64)


def test_kernel_source_and_shared_memory_budget():
    src = tssd.SOURCE.read_text()
    assert 'extern "C" int ssd_scan_launch(' in src
    assert "sm_90a" in " ".join(tssd._build.NVCC_FLAGS)
    # zamba2's forward shape fits one block's shared memory; a chunk of 256
    # at the same state does not, and the wrapper says so before launching
    assert tssd.smem_bytes(128, 64, 64) == 217600 <= tssd.MAX_SMEM_BYTES
    assert tssd.smem_bytes(256, 64, 64) > tssd.MAX_SMEM_BYTES


def test_cuda_kernel_matches_plain_version():
    """On the card only: the kernel against ``ref.ssd_scan_ref`` at the
    sweep shapes (the CUDA kernel has no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD kernel runs only there")
    dev = torch.device("cuda", 0)
    for (bh, l, p, n, chunk) in SWEEP:
        ins = [torch.from_numpy(a).to(dev) for a in _inputs(bh, l, p, n)]
        got = tops.ssd_scan(*ins, chunk=chunk)
        want = tref.ssd_scan_ref(*ins)
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
