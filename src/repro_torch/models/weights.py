"""Weights from the JAX package's parameter pytree.

The reference stacks every block leaf along a leading layer axis
(``params["blocks"]["attn"]["wq"]`` is (n_layers, d, ·), an MoE stack
(n_layers, E, d, f), whisper's ``params["enc_blocks"]`` (enc_layers, ·));
the port keeps one module per layer.  This maps one
onto the other, both ways, so both packages compute the same function on
the same weights, and a port tensor per parameter (a weight, a gradient,
an optimizer moment) can be read as the reference leaf it stacks into.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.mesh import device_of
from repro_torch.models.transformer import LM, model_class, tp_keeper


#: the port's per-layer module lists: the reference stacks each along a
#: leading axis of ``n_layers`` or ``enc_layers``
STACKED = ("blocks", "enc_blocks")


class Leaf(NamedTuple):
    """The port parameters that make one reference leaf, in layer order,
    and that leaf's rank (a stacked leaf has one dim more than each)."""
    names: tuple
    ndim: int


def leaf_groups(model: LM) -> dict:
    """{reference leaf path ("blocks.attn.wq", "final_gamma"): `Leaf`}
    in ``named_parameters`` order.  The optimizer's weight decay and the
    int8 compression's scale follow the reference leaf, not the port
    tensor: a stacked ``blocks.ln1`` is (n_layers, d), rank 2."""
    names, ndim = {}, {}
    for name, p in model.named_parameters():
        head, _, rest = name.partition(".")
        stacked = head in STACKED
        path = f"{head}.{rest.partition('.')[2]}" if stacked else name
        names.setdefault(path, []).append(name)
        ndim[path] = p.dim() + stacked
    return {path: Leaf(tuple(n), ndim[path]) for path, n in names.items()}


def reference_tree(model: LM, tensors: Optional[dict] = None) -> dict:
    """The inverse of `params_from_jax`: the reference pytree (nested
    dicts of numpy arrays, ``blocks`` and ``enc_blocks`` stacked along
    the layer axis) of the model's parameters, or of ``tensors``, one
    tensor per parameter name (e.g. the gradients)."""
    src = dict(model.named_parameters()) if tensors is None else tensors
    tree = {}
    for path, leaf in leaf_groups(model).items():
        arrays = [src[n].detach().cpu().numpy() for n in leaf.names]
        *parents, last = path.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        stacked = path.partition(".")[0] in STACKED
        node[last] = np.stack(arrays) if stacked else arrays[0]
    return tree


def _to_torch(tree, dev, index=None, keep=None, path=""):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev, index, keep,
                             f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    t = torch.tensor(a, device=dev)
    return t if keep is None else keep(path, t)


def params_from_jax(tree: dict, cfg: ArchConfig, device=None,
                    mesh=None) -> LM:
    """The port's model (``transformer.model_class(cfg)``) holding the
    weights of the reference pytree ``tree`` (leaves as numpy arrays or
    anything ``np.asarray`` takes), ``lm_head`` included where the
    embeddings are untied, on ``device`` (None = CUDA).  ``blocks`` is
    split along ``n_layers``, the encoder's ``enc_blocks`` along
    ``enc_layers``.  With a ``mesh`` (on its rank's device) the rank
    keeps its tensor-parallel block of each leaf (`shardings.tp_block`
    given the leaf's path, e.g. ``blocks.mamba.in_proj``), as
    ``transformer.init_params(..., mesh=)`` does, for every family."""
    cls = model_class(cfg)
    dev = device_of(mesh, device)
    keep, m = tp_keeper(cfg, mesh)
    depth = {"blocks": cfg.n_layers, "enc_blocks": cfg.enc_layers}
    model = cls(cfg, {
        key: ([_to_torch(value, dev, i, keep) for i in range(depth[key])]
              if key in depth else _to_torch(value, dev, keep=keep, path=key))
        for key, value in tree.items()})
    model.tp = m
    return model
