"""Fault-tolerant checkpointing (port of ``repro/train/checkpoint.py``).

* atomic: write to ``<dir>/tmp.<step>`` then rename to
  ``<dir>/step_<step>``: a crash mid-write never corrupts the latest
  checkpoint;
* ``manifest.json`` records step, leaf names, shapes, dtypes and the
  caller's ``extra``: restore refuses a tree whose leaves differ;
* arrays are saved as host numpy; restore copies them into the live
  tensors on their own devices;
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


def _flatten(tree, prefix: str = "") -> list:
    """[(name, tensor)] of ``tree`` in a stable order."""
    if isinstance(tree, torch.nn.Module):
        return [(prefix + k, v) for k, v in
                tree.state_dict(keep_vars=True).items()]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _flatten(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, t in enumerate(tree)
                for leaf in _flatten(t, f"{prefix}{i}.")]
    if torch.is_tensor(tree):
        return [(prefix.rstrip("."), tree)]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{prefix!r}")


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = _flatten(tree)
    arrays = {f"leaf_{i}": t.detach().cpu().numpy()
              for i, (_, t) in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "names": [n for n, _ in leaves],
        "shapes": [list(t.shape) for _, t in leaves],
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
    ``like``, each on its own device; returns (like, manifest).  A
    different leaf count, leaf names or shapes raise ValueError before
    anything is written."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _flatten(like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, tree expects "
            f"{len(leaves)}: config mismatch?")
    for i, (name, t) in enumerate(leaves):
        if manifest["names"][i] != name:
            raise ValueError(f"leaf {i}: {manifest['names'][i]!r} in the "
                             f"checkpoint, {name!r} in the tree")
        if manifest["shapes"][i] != list(t.shape):
            raise ValueError(f"leaf {i} ({name}): shape "
                             f"{manifest['shapes'][i]} != {list(t.shape)}")
    with np.load(os.path.join(path, "arrays.npz")) as data, \
            torch.no_grad():
        for i, (_, t) in enumerate(leaves):
            t.copy_(torch.from_numpy(data[f"leaf_{i}"]))
    return like, manifest
