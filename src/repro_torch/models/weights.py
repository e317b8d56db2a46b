"""Weights from the JAX package's parameter pytree.

The reference stacks every block leaf along a leading layer axis
(``params["blocks"]["attn"]["wq"]`` is (n_layers, d, ·), an MoE stack
(n_layers, E, d, f), whisper's ``params["enc_blocks"]`` (enc_layers, ·));
the port keeps one module per layer.  This maps one
onto the other, so both packages compute the same function on the same
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.csr import resolve_device
from repro_torch.models.transformer import LM, model_class


def _to_torch(tree, dev, index=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev, index) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    return torch.tensor(a, device=dev)


def params_from_jax(tree: dict, cfg: ArchConfig, device=None) -> LM:
    """The port's model (``transformer.model_class(cfg)``) holding the
    weights of the reference pytree ``tree`` (leaves as numpy arrays or
    anything ``np.asarray`` takes), ``lm_head`` included where the
    embeddings are untied, on ``device`` (None = CUDA).  ``blocks`` is
    split along ``n_layers``, the encoder's ``enc_blocks`` along
    ``enc_layers``."""
    cls = model_class(cfg)
    dev = resolve_device(device)
    depth = {"blocks": cfg.n_layers, "enc_blocks": cfg.enc_layers}
    return cls(cfg, {
        key: ([_to_torch(value, dev, i) for i in range(depth[key])]
              if key in depth else _to_torch(value, dev))
        for key, value in tree.items()})
