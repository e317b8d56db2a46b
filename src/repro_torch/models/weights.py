"""Weights from the JAX package's parameter pytree.

The reference keeps the hybrid stack's Mamba layers stacked along a
leading layer axis (``params["blocks"]["mamba"]["in_proj"]`` is
(n_layers, d, ·)); the port keeps one module per layer.  This maps one
onto the other, so both packages compute the same function on the same
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.csr import resolve_device
from repro_torch.models.transformer import HybridLM


def _to_torch(tree, dev, index=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev, index) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    return torch.tensor(a, device=dev)


def params_from_jax(tree: dict, cfg: ArchConfig, device=None) -> HybridLM:
    """The port's model holding the weights of the reference pytree
    ``tree`` (leaves as numpy arrays or anything ``np.asarray`` takes),
    on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    blocks = tree["blocks"]
    return HybridLM(cfg, {
        "embed": _to_torch(tree["embed"], dev),
        "final_gamma": _to_torch(tree["final_gamma"], dev),
        "blocks": [_to_torch(blocks, dev, i) for i in range(cfg.n_layers)],
        "shared": _to_torch(tree["shared"], dev),
    })
