"""CUDA pin-count kernel: build, bind and launch.

Replaces the TPU kernel `_pin_affinity_kernel` / `pin_affinity_pallas` of
``src/repro/kernels/pin_affinity.py`` (:33 / :71).  The source is
``csrc/pin_count.cu``; its header states the design and the bound.
Built at first use by ``kernels/build.py`` (``nvcc`` for ``sm_90a``,
``ctypes``); a failed build raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.obs import metrics

SOURCE = Path(__file__).resolve().parent / "csrc" / "pin_count.cu"
LAUNCHES = "kernels/pin_count/launches"


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path."""
    return _build.build(SOURCE, _build.BUILD_DIR, _build.NVCC_FLAGS)


_lib = _build.Library(build, "pin_count_launch", [ctypes.c_void_p] * 6 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int])


def pin_count_cuda(pins: torch.Tensor, pin_mask: torch.Tensor,
                   netw: torch.Tensor, labels: torch.Tensor, k: int):
    """Launch the kernel: int32 pins (e_pad, pmax), f32 pin_mask (e_pad,
    pmax), f32 netw (e_pad,), int32 labels (B, n_pad) → f32 (cnt, score),
    each (B, e_pad, k), on ``pins``' CUDA device and PyTorch's current
    stream.  Raises on anything else."""
    if pins.device.type != "cuda":
        raise ValueError(f"pin_count_cuda needs CUDA tensors, got "
                         f"{pins.device}")
    dev = pins.device
    _build.check_tensor("pins", pins, torch.int32, 2, dev)
    _build.check_tensor("pin_mask", pin_mask, torch.float32, 2, dev)
    _build.check_tensor("netw", netw, torch.float32, 1, dev)
    _build.check_tensor("labels", labels, torch.int32, 2, dev)
    e_pad, pmax = pins.shape
    if pin_mask.shape != pins.shape:
        raise ValueError(f"pin_mask shape {tuple(pin_mask.shape)} != pins "
                         f"shape {tuple(pins.shape)}")
    if netw.shape[0] != e_pad:
        raise ValueError(f"netw shape {tuple(netw.shape)} does not match "
                         f"e_pad={e_pad}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    batch, n_pad = labels.shape
    cnt = torch.empty((batch, e_pad, k), dtype=torch.float32, device=dev)
    score = torch.empty_like(cnt)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _lib.launch(pins.data_ptr(), pin_mask.data_ptr(), netw.data_ptr(),
                labels.data_ptr(), cnt.data_ptr(), score.data_ptr(), batch,
                e_pad, n_pad, pmax, k, stream, dev.index)
    metrics.inc(LAUNCHES)
    return cnt, score
