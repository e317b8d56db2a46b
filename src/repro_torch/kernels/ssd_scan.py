"""CUDA SSD-scan kernel: build, bind and launch.

Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_pallas` of
``src/repro/kernels/ssd_scan.py`` (:27 / :77).  The source is
``csrc/ssd_scan.cu``; its header states the design and the bound.  Built
at first use by ``kernels/build.py`` (``nvcc`` for ``sm_90a``,
``ctypes``); a failed build raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.obs import metrics

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
LAUNCHES = "kernels/ssd_scan/launches"
#: the most shared memory a block can opt into on Hopper
MAX_SMEM_BYTES = 232448


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path."""
    return _build.build(SOURCE, _build.BUILD_DIR, _build.NVCC_FLAGS)


_lib = _build.Library(build, "ssd_scan_launch", [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int])


def smem_bytes(chunk: int, n: int, p: int) -> int:
    """Shared memory of one block, as ``csrc/ssd_scan.cu`` lays it out."""
    lq = chunk + 4
    return 4 * (chunk * p + chunk * n + 2 * n * lq + chunk * lq + n * p
                + chunk)


def ssd_scan_cuda(x: torch.Tensor, logdecay: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Launch the kernel: f32 x (BH, L, P), logdecay (BH, L), b and c
    (BH, L, N) → f32 y (BH, L, P), on ``x``'s CUDA device and PyTorch's
    current stream.  L must be a multiple of ``chunk``, ``chunk`` of 8, and
    N and P of 4 (``ops.ssd_scan`` pads to these).  Raises on anything
    else."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {x.device}")
    dev = x.device
    _build.check_tensor("x", x, torch.float32, 3, dev)
    _build.check_tensor("logdecay", logdecay, torch.float32, 2, dev)
    _build.check_tensor("b", b, torch.float32, 3, dev)
    _build.check_tensor("c", c, torch.float32, 3, dev)
    bh, l, p = x.shape
    n = b.shape[-1]
    if tuple(logdecay.shape) != (bh, l):
        raise ValueError(f"logdecay shape {tuple(logdecay.shape)} != "
                         f"{(bh, l)}")
    if tuple(b.shape) != (bh, l, n) or tuple(c.shape) != (bh, l, n):
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must "
                         f"both be {(bh, l, n)}")
    if chunk <= 0 or chunk % 8 or l % chunk or n % 4 or p % 4:
        raise ValueError(f"ssd_scan_cuda needs chunk % 8 == 0, L % chunk "
                         f"== 0 and N, P multiples of 4; got chunk={chunk} "
                         f"L={l} N={n} P={p}")
    if smem_bytes(chunk, n, p) > MAX_SMEM_BYTES:
        raise ValueError(f"chunk={chunk}, N={n}, P={p} needs "
                         f"{smem_bytes(chunk, n, p)} B of shared memory, "
                         f"more than {MAX_SMEM_BYTES}")
    y = torch.empty((bh, l, p), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _lib.launch(x.data_ptr(), logdecay.data_ptr(), b.data_ptr(),
                c.data_ptr(), y.data_ptr(), bh, l, p, n, chunk, stream,
                dev.index)
    metrics.inc(LAUNCHES)
    return y
