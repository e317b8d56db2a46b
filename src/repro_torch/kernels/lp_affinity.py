"""CUDA block-affinity kernel: build, bind and launch.

Replaces the TPU kernel `_affinity_kernel` / `affinity_pallas` of
``src/repro/kernels/lp_affinity.py`` (:30 / :64).  The source is
``csrc/lp_affinity.cu``; its header states the design and the bound.
Built at first use by ``kernels/build.py`` (``nvcc`` for ``sm_90a``,
``ctypes``); a failed build raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.obs import metrics

SOURCE = Path(__file__).resolve().parent / "csrc" / "lp_affinity.cu"
BUILD_DIR = _build.BUILD_DIR
NVCC_FLAGS = _build.NVCC_FLAGS
LAUNCHES = "kernels/lp_affinity/launches"


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path."""
    return _build.build(SOURCE, BUILD_DIR, NVCC_FLAGS)


_lib = _build.Library(build, "lp_affinity_launch", [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int])


def affinity_cuda(nbr: torch.Tensor, wgt: torch.Tensor, labels: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Launch the kernel: int32 nbr (n_pad, dmax), f32 wgt (n_pad, dmax),
    int32 labels (B, n_pad) → f32 aff (B, n_pad, k), on ``nbr``'s CUDA
    device and PyTorch's current stream.  Raises on anything else."""
    if nbr.device.type != "cuda":
        raise ValueError(f"affinity_cuda needs CUDA tensors, got {nbr.device}")
    dev = nbr.device
    _build.check_tensor("nbr", nbr, torch.int32, 2, dev)
    _build.check_tensor("wgt", wgt, torch.float32, 2, dev)
    _build.check_tensor("labels", labels, torch.int32, 2, dev)
    n_pad, dmax = nbr.shape
    if wgt.shape != nbr.shape:
        raise ValueError(f"wgt shape {tuple(wgt.shape)} != nbr shape "
                         f"{tuple(nbr.shape)}")
    if labels.shape[1] != n_pad:
        raise ValueError(f"labels shape {tuple(labels.shape)} does not "
                         f"match n_pad={n_pad}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    batch = labels.shape[0]
    out = torch.empty((batch, n_pad, k), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _lib.launch(nbr.data_ptr(), wgt.data_ptr(), labels.data_ptr(),
                out.data_ptr(), batch, n_pad, dmax, k, stream, dev.index)
    metrics.inc(LAUNCHES)
    return out
