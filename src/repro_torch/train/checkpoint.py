"""Fault-tolerant checkpointing (port of ``repro/train/checkpoint.py``).

* atomic: write to ``<dir>/tmp.<step>`` then rename to
  ``<dir>/step_<step>``: a crash mid-write never corrupts the latest
  checkpoint;
* ``manifest.json`` records step, leaf names, shapes, dtypes and the
  caller's ``extra``: restore refuses a tree whose leaves differ;
* arrays are saved unsharded (host-gathered), as host numpy; restore
  copies them into the live tensors on their own devices, re-sharded
  onto whatever mesh the restarted job's model holds (elastic): the
  parameters of a model built on a mesh (``transformer.init_params(...,
  mesh=)``) and every optimizer tensor keyed by a parameter's name (μ,
  ν, the int8 error feedback) are each gathered whole from the ranks'
  blocks (`shardings.whole_leaf`, a collective: every rank of the mesh
  calls `save`, one writes) and cut to the rank's block on restore
  (`shardings.rank_block`);
* retention: keep the newest ``keep`` checkpoints.

A tree is a module (its ``state_dict``), a dict of tensors or trees (in
sorted key order), a list or tuple of trees, or a tensor.  The train
loop saves ``(model, opt_state)``: the model's ``state_dict``, then the
optimizer's moments and step.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import shardings as SH


def _sharded_model(tree):
    """The model of ``tree`` (the tree, or an element of a top-level list
    or tuple) where it holds a mesh's blocks, else None."""
    for t in (tree,) + (tuple(tree) if isinstance(tree, (list, tuple))
                        else ()):
        if getattr(t, "mesh", None) is not None and (t.tp > 1
                                                     or t.fsdp > 1):
            return t
    return None


def _flatten(tree, prefix: str = "", params=frozenset()) -> list:
    """[(name, tensor, parameter)] of ``tree`` in a stable order:
    ``parameter`` is the name of the model parameter whose blocks the
    tensor holds (a parameter, or an entry of a dict keyed by the
    ``params`` names: μ, ν, the error feedback), else None."""
    if isinstance(tree, torch.nn.Module):
        return [(prefix + k, v, k if k in params else None) for k, v in
                tree.state_dict(keep_vars=True).items()]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            if torch.is_tensor(tree[k]) and k in params:
                out.append((f"{prefix}{k}", tree[k], k))
            else:
                out.extend(_flatten(tree[k], f"{prefix}{k}.", params))
        return out
    if isinstance(tree, (list, tuple)):
        return [leaf for i, t in enumerate(tree)
                for leaf in _flatten(t, f"{prefix}{i}.", params)]
    if torch.is_tensor(tree):
        return [(prefix.rstrip("."), tree, None)]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{prefix!r}")


def _leaves(tree) -> tuple:
    """(the sharded model or None, `_flatten` of ``tree`` with its
    parameters' names)."""
    model = _sharded_model(tree)
    params = (frozenset(n for n, _ in model.named_parameters())
              if model is not None else frozenset())
    return model, _flatten(tree, params=params)


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3, write: bool = True) -> Optional[str]:
    """Write ``tree`` as checkpoint ``step``, every leaf whole.  Where the
    tree's model holds a mesh's blocks, every rank of the mesh calls
    this (the leaves are gathered over it) and only the one with
    ``write`` writes; the others return None."""
    model, leaves = _leaves(tree)
    arrays = {}
    for i, (_, t, param) in enumerate(leaves):
        t = t.detach()
        if param is not None:
            t = SH.whole_leaf(param, t, model.cfg, model.mesh)
        if write:
            arrays[f"leaf_{i}"] = t.cpu().numpy()
    if not write:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "names": [n for n, _, _ in leaves],
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None):
    """Copy checkpoint ``step`` (default: the latest) into the tensors of
    ``like``, each on its own device, each sharded leaf cut to the
    rank's block of the mesh its model holds; returns (like, manifest).
    A different leaf count, leaf names or whole shapes raise ValueError
    before anything is written."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    model, leaves = _leaves(like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, tree expects "
            f"{len(leaves)}: config mismatch?")
    for i, (name, t, param) in enumerate(leaves):
        if manifest["names"][i] != name:
            raise ValueError(f"leaf {i}: {manifest['names'][i]!r} in the "
                             f"checkpoint, {name!r} in the tree")
        shape = list(t.shape) if param is None else list(SH.whole_shape(
            param, t.shape, model.cfg, model.mesh))
        if manifest["shapes"][i] != shape:
            raise ValueError(f"leaf {i} ({name}): shape "
                             f"{manifest['shapes'][i]} != {shape}")
    with np.load(os.path.join(path, "arrays.npz")) as data, \
            torch.no_grad():
        for i, (_, t, param) in enumerate(leaves):
            a = torch.from_numpy(data[f"leaf_{i}"])
            if param is not None:
                a = SH.rank_block(param, a, model.cfg, model.mesh)
            t.copy_(a)
    return like, manifest
