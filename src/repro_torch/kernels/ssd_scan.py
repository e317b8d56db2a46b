"""CUDA SSD-scan kernel: build, bind and launch.

Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_pallas` of
``src/repro/kernels/ssd_scan.py`` (:27 / :77).  The source is
``csrc/ssd_scan.cu``; its header states the design and the bound.  One
call is three device launches on the current stream: the chunk states
(one block per group, chunk and tile of 4 heads, tensor-core products),
the short sequential pass over the chunks, and the outputs (C·Bᵀ formed
once per block for its heads).  The ``heads`` contract: rows of x come in
groups of ``heads`` consecutive rows that share one row of b and c.
Built at first use by ``kernels/build.py`` (``nvcc`` for ``sm_90a``,
``ctypes``); a failed build raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.obs import metrics

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
LAUNCHES = "kernels/ssd_scan/launches"      # counts calls, not launches
#: the most shared memory a block can opt into on Hopper
MAX_SMEM_BYTES = 232448
#: shapes the kernels take: chunk and N multiples of 16, P of 8
CHUNK_MULT, N_MULT, P_MULT = 16, 16, 8


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path."""
    return _build.build(SOURCE, _build.BUILD_DIR, _build.NVCC_FLAGS)


_lib = _build.Library(build, "ssd_scan_launch", [ctypes.c_void_p] * 7 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int])


def _pad_rk(v: int) -> int:
    return (v + 15) // 16 * 16 + 4


def _pad_kn(v: int) -> int:
    return (v + 15) // 16 * 16 + 8


def smem_bytes(chunk: int, n: int, p: int) -> dict:
    """Shared memory of one block of each kernel, as ``csrc/ssd_scan.cu``
    lays it out (``state_layout``, ``out_layout``)."""
    state = chunk * (_pad_kn(n) + 2 * _pad_kn(p)) + 2 * chunk
    out = (chunk * _pad_rk(n) + chunk * max(_pad_rk(n), _pad_kn(p))
           + chunk * _pad_rk(chunk) + chunk * _pad_kn(p)
           + 2 * n * _pad_kn(p) + 2 * chunk)
    return {"state": 4 * state, "out": 4 * out}


def ssd_scan_cuda(x: torch.Tensor, logdecay: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, chunk: int = 128,
                  heads: int = 1) -> torch.Tensor:
    """Launch the kernels: f32 x (BH, L, P), logdecay (BH, L), b and c
    (BH / heads, L, N) → f32 y (BH, L, P), on ``x``'s CUDA device and
    PyTorch's current stream.  L must be a multiple of ``chunk``, ``chunk``
    and N of 16, P of 8 (``ops.ssd_scan`` pads to these); x, b and c
    16-byte aligned.  Raises on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {x.device}")
    dev = x.device
    _build.check_tensor("x", x, torch.float32, 3, dev)
    _build.check_tensor("logdecay", logdecay, torch.float32, 2, dev)
    _build.check_tensor("b", b, torch.float32, 3, dev)
    _build.check_tensor("c", c, torch.float32, 3, dev)
    bh, l, p = x.shape
    n = b.shape[-1]
    if heads < 1 or bh % heads:
        raise ValueError(f"BH={bh} is not a multiple of heads={heads}")
    groups = bh // heads
    if tuple(logdecay.shape) != (bh, l):
        raise ValueError(f"logdecay shape {tuple(logdecay.shape)} != "
                         f"{(bh, l)}")
    if tuple(b.shape) != (groups, l, n) or tuple(c.shape) != (groups, l, n):
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must "
                         f"both be {(groups, l, n)}")
    if (chunk <= 0 or chunk % CHUNK_MULT or l % chunk or n % N_MULT
            or p % P_MULT):
        raise ValueError(f"ssd_scan_cuda needs chunk % {CHUNK_MULT} == 0, "
                         f"L % chunk == 0, N % {N_MULT} == 0 and P % "
                         f"{P_MULT} == 0; got chunk={chunk} L={l} N={n} "
                         f"P={p}")
    need = max(smem_bytes(chunk, n, p).values())
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"chunk={chunk}, N={n}, P={p} needs {need} B of "
                         f"shared memory, more than {MAX_SMEM_BYTES}")
    for name, t in (("x", x), ("b", b), ("c", c)):   # copied 16 B at a time
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    nc = l // chunk
    y = torch.empty((bh, l, p), dtype=torch.float32, device=dev)
    states = torch.empty((bh, nc, n, p), dtype=torch.float32, device=dev)
    tot = torch.empty((bh, nc), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _lib.launch(x.data_ptr(), logdecay.data_ptr(), b.data_ptr(),
                c.data_ptr(), y.data_ptr(), states.data_ptr(),
                tot.data_ptr(), bh, heads, l, p, n, chunk, stream,
                dev.index)
    metrics.inc(LAUNCHES)
    return y
