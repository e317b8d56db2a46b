"""CUDA pin-count kernel: build, bind and launch.

Replaces the TPU kernel `_pin_affinity_kernel` / `pin_affinity_pallas` of
``src/repro/kernels/pin_affinity.py`` (:33 / :71).  The source is
``csrc/pin_count.cu``; its header states the design and the bound.  One
kernel body has two entries: ``pin_count_csr_cuda`` reads a net's pins
from the flat pin list by its offsets (the refinement scan's call, cnt
only), ``pin_count_cuda`` from the padded (e_pad, pmax) ELL (cnt and
score, as the TPU kernel).  Built at first use by ``kernels/build.py``
(``nvcc`` for ``sm_90a``, ``ctypes``); a failed build raises.
"""
from __future__ import annotations

import ctypes
import weakref
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
_lib_csr = _build.Library(build, "pin_count_csr_launch", [
    ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int])


def _check_aligned(**tensors) -> None:
    """The kernel stages pins and masks with 16-byte loads."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


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
    _check_aligned(pins=pins, pin_mask=pin_mask)
    batch, n_pad = labels.shape
    cnt = torch.empty((batch, e_pad, k), dtype=torch.float32, device=dev)
    score = torch.empty_like(cnt)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _lib.launch(pins.data_ptr(), pin_mask.data_ptr(), netw.data_ptr(),
                labels.data_ptr(), cnt.data_ptr(), score.data_ptr(), batch,
                e_pad, n_pad, pmax, k, stream, dev.index)
    metrics.inc(LAUNCHES)
    return cnt, score


# id(eptr) -> (weak reference, version, p_pad) of offsets already checked
_CHECKED_OFFSETS: dict = {}


def check_offsets(eptr: torch.Tensor, p_pad: int) -> None:
    """Raise unless the offsets run from eptr[0] >= 0 to eptr[-1] <= p_pad
    without decreasing.  They are read on the host (a device sync) once per
    tensor and version: a scan passes one level's offsets to every round,
    and an in-place change of ``eptr`` bumps its version (an inference
    tensor has none, so its offsets are read at every call)."""
    key = id(eptr)
    version = None if eptr.is_inference() else eptr._version
    seen = _CHECKED_OFFSETS.get(key)
    if (version is not None and seen is not None and seen[0]() is eptr
            and seen[1:] == (version, p_pad)):
        return
    first, last, falls = torch.stack([
        eptr[0].long(), eptr[-1].long(),
        (eptr[1:] < eptr[:-1]).sum()]).tolist()
    if first < 0 or last > p_pad or falls:
        raise ValueError(f"eptr runs from {first} to {last} over {p_pad} "
                         f"pins and decreases {falls} times")
    if version is not None:
        _CHECKED_OFFSETS[key] = (weakref.ref(
            eptr, lambda _, key=key: _CHECKED_OFFSETS.pop(key, None)),
            version, p_pad)


def check_csr(eptr: torch.Tensor, pv: torch.Tensor, mask: torch.Tensor,
              labels: torch.Tensor, k: int) -> None:
    """Raise unless (eptr, pv, mask, labels, k) is what the CSR entry
    takes: contiguous int32 eptr (e_pad + 1 >= 1,), int32 pv and f32 mask
    of one shape (p_pad,), 16-byte aligned, int32 labels (B, n_pad), all on
    ``pv``'s device, k >= 1, and offsets that ``check_offsets`` passes."""
    dev = pv.device
    _build.check_tensor("eptr", eptr, torch.int32, 1, dev)
    _build.check_tensor("pv", pv, torch.int32, 1, dev)
    _build.check_tensor("mask", mask, torch.float32, 1, dev)
    _build.check_tensor("labels", labels, torch.int32, 2, dev)
    if mask.shape != pv.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != pv shape "
                         f"{tuple(pv.shape)}")
    if eptr.numel() < 1:
        raise ValueError("eptr needs e_pad + 1 >= 1 offsets")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    _check_aligned(pv=pv, mask=mask)
    check_offsets(eptr, pv.numel())


def pin_count_csr_cuda(eptr: torch.Tensor, pv: torch.Tensor,
                       mask: torch.Tensor, labels: torch.Tensor, k: int):
    """Launch the kernel on the pin list: int32 eptr (e_pad + 1,) offsets
    into int32 pv and f32 mask (p_pad,), int32 labels (B, n_pad) → f32 cnt
    (B, e_pad, k), on ``pv``'s CUDA device and PyTorch's current stream.
    Net e's pins are ``pv[eptr[e]:eptr[e + 1]]``; pins past ``eptr[-1]``
    lie in no net and are never read.  Raises on anything else
    (``check_csr``)."""
    if pv.device.type != "cuda":
        raise ValueError(f"pin_count_csr_cuda needs CUDA tensors, got "
                         f"{pv.device}")
    check_csr(eptr, pv, mask, labels, k)
    dev = pv.device
    e_pad = eptr.numel() - 1
    batch, n_pad = labels.shape
    cnt = torch.empty((batch, e_pad, k), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _lib_csr.launch(eptr.data_ptr(), pv.data_ptr(), mask.data_ptr(),
                    labels.data_ptr(), cnt.data_ptr(), batch, e_pad, n_pad,
                    pv.numel(), k, stream, dev.index)
    metrics.inc(LAUNCHES)
    return cnt
