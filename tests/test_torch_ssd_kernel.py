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


def test_merge_heads_keeps_b_and_c_unbroadcast():
    """The kernel engine's layout: heads merged into rows, B and C left
    (B, L, N), and the grouped call equals the per-row call on B and C
    expanded to every head."""
    rng = np.random.default_rng(5)
    bsz, l, nh, hd, n = 2, 40, 3, 8, 4
    x_eff = torch.from_numpy(rng.standard_normal(
        (bsz, l, nh, hd)).astype(np.float32))
    ld = torch.from_numpy((-0.1 - rng.random((bsz, l, nh))).astype(
        np.float32))
    bm, cm = (torch.from_numpy(rng.standard_normal((bsz, l, n)).astype(
        np.float32)) for _ in range(2))
    xs, lds, bs, cs = tM2.merge_heads(x_eff, ld, bm, cm)
    assert xs.shape == (bsz * nh, l, hd) and lds.shape == (bsz * nh, l)
    assert bs.shape == (bsz, l, n) and cs.shape == (bsz, l, n)
    got = tops.ssd_scan(xs, lds, bs, cs, chunk=16, heads=nh)
    flat = [m[:, None].expand(bsz, nh, l, n).reshape(bsz * nh, l, n)
            for m in (bs, cs)]
    assert torch.equal(got, tops.ssd_scan(xs, lds, *flat, chunk=16))


def test_cuda_wrapper_refuses_cpu_tensors():
    x, ld, b, c = (torch.from_numpy(a) for a in _inputs(2, 128, 8, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tssd.ssd_scan_cuda(x, ld, b, c, chunk=64)


def _grouped_inputs(g, heads, l, p, n, seed):
    """x and log-decay per row, B and C per group of ``heads`` rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g * heads, l, p)).astype(np.float32)
    ld = (-0.05 - 0.5 * rng.random((g * heads, l))).astype(np.float32)
    b = (rng.standard_normal((g, l, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((g, l, n)) * 0.3).astype(np.float32)
    return x, ld, b, c


# (groups, heads, L, P, N, chunk): L = 200 is not a multiple of the chunk
GROUPED = [(2, 1, 128, 8, 4, 64), (1, 3, 200, 16, 8, 64),
           (2, 4, 96, 32, 16, 32), (1, 3, 256, 8, 8, 128)]


@pytest.mark.parametrize("g,heads,l,p,n,chunk", GROUPED)
def test_grouped_plain_version_matches_oracle(g, heads, l, p, n, chunk):
    """``ops.ssd_scan(..., heads=h)`` on the CPU against the JAX package's
    sequential oracle on B and C broadcast to every head with numpy."""
    x, ld, b, c = _grouped_inputs(g, heads, l, p, n, seed=g + heads + l)
    got = tops.ssd_scan(*(torch.from_numpy(a) for a in (x, ld, b, c)),
                        chunk=chunk, heads=heads).numpy()
    bb, cc = (np.repeat(m, heads, axis=0) for m in (b, c))
    want = np.asarray(rref.ssd_scan_ref(*(jnp.asarray(a)
                                          for a in (x, ld, bb, cc))))
    assert got.shape == (g * heads, l, p) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_grouped_call_rejects_a_mismatched_group():
    x, ld, b, c = (torch.from_numpy(a)
                   for a in _grouped_inputs(2, 3, 64, 8, 4, seed=0))
    with pytest.raises(ValueError, match="heads"):
        tops.ssd_scan(x, ld, b, c, chunk=32, heads=2)


def test_kernel_source_and_shared_memory_budget():
    src = tssd.SOURCE.read_text()
    assert 'extern "C" int ssd_scan_launch(' in src
    assert "sm_90a" in " ".join(tssd._build.NVCC_FLAGS)
    # zamba2's forward shape: the state pass holds B and two X buffers of
    # one chunk (111,616 B, two blocks per SM), the output pass C, C Bᵀ and
    # two (X, h_prev) buffers, the first over B (214,016 B, one block per
    # SM); a chunk of 256 at the same state does not fit, and the wrapper
    # says so before launching
    assert tssd.smem_bytes(128, 64, 64) == {"state": 111616, "out": 214016}
    assert max(tssd.smem_bytes(128, 64, 64).values()) <= tssd.MAX_SMEM_BYTES
    assert max(tssd.smem_bytes(256, 64, 64).values()) > tssd.MAX_SMEM_BYTES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD kernels run only there")
    return torch.device("cuda", 0)


def test_cuda_kernel_matches_plain_version(cuda_device):
    """On the card only: the kernels against the exact recurrence at the
    sweep shapes, per-row and grouped (the CUDA kernels have no CPU
    mode)."""
    for (bh, l, p, n, chunk) in SWEEP:
        ins = [torch.from_numpy(a).to(cuda_device)
               for a in _inputs(bh, l, p, n)]
        got = tops.ssd_scan(*ins, chunk=chunk)
        want = tref.ssd_scan_ref(*ins)
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    for (g, heads, l, p, n, chunk) in GROUPED:
        ins = [torch.from_numpy(a).to(cuda_device) for a in
               _grouped_inputs(g, heads, l, p, n, seed=g + heads + l)]
        got = tops.ssd_scan(*ins, chunk=chunk, heads=heads)
        want = tref.ssd_scan_grouped_ref(*ins, heads)
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
