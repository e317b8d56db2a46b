"""Production mesh construction (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group and no device.  Each returns a `core.mesh.Mesh` over the
default process group, which the caller has initialised
(``torch.distributed.init_process_group``: NCCL for CUDA ranks, gloo for
``device="cpu"``).  A world whose size is not the mesh's is refused; the
shape is never shrunk to fit it.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.mesh import Mesh


def production_layout(*, multi_pod: bool = False):
    """(shape, axes) of the reference's production layouts: (data 16,
    model 16), or (pod 2, data 16, model 16) with ``multi_pod``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production layouts (`production_layout`) over the
    default process group."""
    shape, axes = production_layout(multi_pod=multi_pod)
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device=None) -> Mesh:
    """A ``shape`` mesh with axis names ``axes`` over every rank of the
    default process group, on this rank's ``device`` (None = CUDA)."""
    import torch.distributed as dist
    shape = tuple(int(s) for s in shape)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    size = 1
    for s in shape:
        size *= s
    if dist.get_world_size() != size:
        raise ValueError(f"mesh shape {shape} needs {size} ranks, the world "
                         f"has {dist.get_world_size()}")
    return Mesh.world(tuple(axes), shape, device=device)
