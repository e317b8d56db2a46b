"""Shared neural-net layers (port of ``repro/models/layers.py``): plain
functions over tensors.  Parameters are initialised from an explicit
``torch.Generator``, so one seed gives one set of weights on a device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def normal(gen: torch.Generator, shape, scale: float, dtype,
           device=None) -> torch.Tensor:
    """``scale`` · N(0, 1) drawn in f32 from ``gen`` (on ``gen``'s device
    unless ``device`` says otherwise), cast to ``dtype``."""
    device = gen.device if device is None else device
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (t * scale).to(dtype)


def whole(name: str, t: torch.Tensor) -> torch.Tensor:
    """The default ``keep`` of the ``init_*`` functions: hold every drawn
    tensor whole (a sharded init passes the rank's block instead)."""
    return t


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32 with a zero-centred gain: x̂ · (1 + gamma)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + gamma.float())).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """The 2-matrix GELU MLP (starcoder2) with the tanh approximation,
    ``jax.nn.gelu``'s default."""
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


def rope_freqs(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions: (...,) integer → cos/sin of shape (..., dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, dim); cos/sin: (..., seq, dim//2)."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def causal_mask(q_len: int, kv_len: int, q_offset=0, device=None,
                window: Optional[int] = None) -> torch.Tensor:
    """(q_len, kv_len) bool mask, True = attend; query i sits at position
    i + ``q_offset``.  A (B,) tensor ``q_offset`` gives one mask per row,
    (B, q_len, kv_len).  ``window`` keeps only keys k > q − window
    (sliding-window layers; None = global)."""
    q = torch.arange(q_len, device=device)[:, None]
    if torch.is_tensor(q_offset):
        q = q + q_offset.reshape(-1, 1, 1)
    else:
        q = q + q_offset
    k = torch.arange(kv_len, device=device)
    m = k <= q
    if window is not None:
        m = m & (k > q - window)
    return m


class ParamTree(torch.nn.Module):
    """A nested dict of tensors as a module: each tensor becomes a frozen
    parameter and each dict a child module, under the reference pytree's
    own keys (``p.attn.wq`` for ``params["attn"]["wq"]``), so the
    module's ``state_dict`` names follow the JAX package's parameter
    paths.  The parameters are frozen (no gradient) until a trainer turns
    them on with ``model.requires_grad_(True)``."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(
                    key, torch.nn.Parameter(value, requires_grad=False))
