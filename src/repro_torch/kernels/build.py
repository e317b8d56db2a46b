"""Build plumbing shared by the hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface.  At first use it is compiled with ``nvcc`` for ``sm_90a`` into
a shared library in ``build/kernels/`` at the repository root, under a
name keyed by a hash of the source and the flags (an edit rebuilds it),
and loaded with ``ctypes``.  A failed build raises.  Nothing is built or
loaded when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

import torch

from repro_torch.obs import metrics

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on "
                           "PATH or set CUDA_HOME")
    return str(path)


def build(source: Path, build_dir: Path, flags: Sequence[str]) -> Path:
    """Compile ``source`` into a library if it is not built yet; return
    the library's path."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    lib = build_dir / f"{source.stem}-{digest}.so"
    if lib.exists():
        return lib
    compiler = nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)         # atomic: concurrent builds agree
    metrics.inc("kernels/builds")
    return lib


class Library:
    """One kernel library's launcher, built and loaded at first call.

    ``build_fn`` returns the library's path; ``symbol`` is its
    ``extern "C"`` launcher, which returns a CUDA error code (0 = ok).
    """

    def __init__(self, build_fn: Callable[[], Path], symbol: str,
                 argtypes: Sequence):
        self._build_fn = build_fn
        self._symbol = symbol
        self._argtypes = list(argtypes)
        self._fn = None
        self._lock = threading.Lock()

    def launcher(self):
        with self._lock:
            if self._fn is None:
                fn = getattr(ctypes.CDLL(str(self._build_fn())),
                             self._symbol)
                fn.argtypes = self._argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def launch(self, *args) -> None:
        """Call the launcher; raise on a non-zero CUDA error code."""
        rc = self.launcher()(*args)
        if rc != 0:
            raise RuntimeError(f"{self._symbol} failed: CUDA error {rc}")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dims on ``device``: what a kernel's raw pointer may point at."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
