"""Fused attention forward kernel: build, bind and launch.

Replaces no TPU kernel: the JAX package has no Pallas attention kernel and
leaves attention to XLA.  The kernel is added because the port's composed
attention (``models/attention._sdpa``) writes the whole (B, H, Sq, Skv)
f32 logits tensor to device memory and passes over it five times.  The
source is ``csrc/attention_fwd.cu``; its header states the design and the
bound.  One call is one launch on the current stream (one per 65535 /
heads rows of the batch).  The kernel has no backward.  Built at first use
by ``kernels/build.py`` (``nvcc`` for ``sm_90a``, ``ctypes``); a failed
build raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.obs import metrics

SOURCE = Path(__file__).resolve().parent / "csrc" / "attention_fwd.cu"
LAUNCHES = "kernels/attention/launches"     # counts calls, not launches
#: the head sizes the kernel is built for
HEAD_DIMS = (64, 80, 128)
#: query rows per block and keys per streamed tile
Q_TILE = KV_TILE = 64
#: what a position may reach: the kernel indexes positions as 32-bit ints
MAX_POSITION = 2 ** 31 - 1


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path."""
    return _build.build(SOURCE, _build.BUILD_DIR, _build.NVCC_FLAGS)


_lib = _build.Library(build, "attn_fwd_launch", [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong] * 9 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int])


def smem_bytes(hd: int) -> int:
    """Shared memory of one block, as ``csrc/attention_fwd.cu`` lays it
    out (``Tile``): Qᵀ, one K and one V slot, Pᵀ, rows padded by 4."""
    return 4 * (hd * (Q_TILE + 4) + 2 * KV_TILE * (hd + 4)
                + KV_TILE * (Q_TILE + 4))


def readable(t: torch.Tensor) -> bool:
    """Whether the kernel can read ``t``'s rows 16 bytes at a time: unit
    stride in hd, the other strides multiples of 4, a 16-byte aligned
    start."""
    return (t.stride(-1) == 1 and not any(s % 4 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check(name: str, t: torch.Tensor, dev: torch.device) -> None:
    """Raise unless ``t`` is a 4-dim f32 tensor on ``dev`` that the kernel
    can read (``readable``)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    if t.dim() != 4:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"(B, S, heads, hd)")
    if not readable(t):
        raise ValueError(f"{name} needs unit stride in hd, strides that are "
                         f"multiples of 4 and a 16-byte aligned start; got "
                         f"strides {t.stride()}")


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, q_offset: int = 0, window=None,
                   is_causal: bool = True, cap=None) -> torch.Tensor:
    """Launch the kernel: f32 q (B, Sq, H, hd), k and v (B, Skv, KV, hd) →
    f32 o (B, Sq, H, hd), contiguous, on ``q``'s CUDA device and
    PyTorch's current stream.  hd in ``HEAD_DIMS``, H a multiple of KV;
    any strides with unit stride in hd, multiples of 4 elsewhere, and
    16-byte aligned starts (``ops.attention_fwd`` copies what is not).
    Raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, dev)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, skv, kvh, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"both be {(b, skv, kvh, hd)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} is not one of {HEAD_DIMS}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"{h} query heads do not share {kvh} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    if cap is not None and cap <= 0:
        raise ValueError(f"cap {cap} must be positive")
    q_offset = int(q_offset)
    if (abs(q_offset) + sq + skv + (window or 0) > MAX_POSITION
            or h > 65535):
        raise ValueError(f"positions up to {q_offset} + {sq} against "
                         f"{skv} keys (window {window}) and {h} heads "
                         f"exceed the kernel's 32-bit indices")
    o = torch.empty((b, sq, h, hd), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _lib.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                b, sq, skv, h, kvh, hd, q_offset, window or 0,
                int(is_causal), scale, cap or 0.0, stream, dev.index)
    metrics.inc(LAUNCHES)
    return o
