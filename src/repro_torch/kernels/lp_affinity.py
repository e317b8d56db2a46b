"""CUDA block-affinity kernel: build, bind and launch.

Replaces the TPU kernel `_affinity_kernel` / `affinity_pallas` of
``src/repro/kernels/lp_affinity.py`` (:30 / :64).  The source is
``csrc/lp_affinity.cu``; its header states the design and the bound.

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/kernels/`` at the repository root, under a name
keyed by a hash of the source and the flags, so an edit rebuilds it.  A
failed build raises.  Nothing is built or imported when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.obs import metrics

SOURCE = Path(__file__).resolve().parent / "csrc" / "lp_affinity.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
LAUNCHES = "kernels/lp_affinity/launches"

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on "
                           "PATH or set CUDA_HOME")
    return str(path)


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lp_affinity-{digest}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)         # atomic: concurrent builds agree
    metrics.inc("kernels/builds")
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.lp_affinity_launch
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def affinity_cuda(nbr: torch.Tensor, wgt: torch.Tensor, labels: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Launch the kernel: int32 nbr (n_pad, dmax), f32 wgt (n_pad, dmax),
    int32 labels (B, n_pad) → f32 aff (B, n_pad, k), on ``nbr``'s CUDA
    device and PyTorch's current stream.  Raises on anything else."""
    if nbr.device.type != "cuda":
        raise ValueError(f"affinity_cuda needs CUDA tensors, got {nbr.device}")
    dev = nbr.device
    _check("nbr", nbr, torch.int32, 2, dev)
    _check("wgt", wgt, torch.float32, 2, dev)
    _check("labels", labels, torch.int32, 2, dev)
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
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.lp_affinity_launch(nbr.data_ptr(), wgt.data_ptr(),
                                labels.data_ptr(), out.data_ptr(), batch,
                                n_pad, dmax, k, stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"lp_affinity launch failed: CUDA error {rc}")
    metrics.inc(LAUNCHES)
    return out
