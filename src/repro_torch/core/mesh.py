"""The device mesh of the distributed programs, on ``torch.distributed``.

The port's counterparts of the JAX package's SPMD pieces:

  * `Mesh` — ``jax.sharding.Mesh``: a shape and axis names (``("nodes",)``
    for parhip, ``("nets",)`` or ``("nets", "verts")`` for parhyp,
    ``("islands",)`` for the memetic ring) over the ranks of a
    ``torch.distributed`` process group, and the rank's own device.
  * ``repro/compat.py:shard_map`` — has none of its own: every rank of the
    group runs the program's per-shard body at once on its own shard, as
    one process per device, and holds the replicated vectors itself.
  * ``jax.lax.psum`` / ``pmax`` / ``pmin`` over one axis — `Mesh.psum`,
    `Mesh.pmax`, `Mesh.pmin`: an all-reduce on that axis's subgroup.
  * ``jax.lax.axis_index`` — `Mesh.axis_index`.
  * ``jax.lax.ppermute`` — `Mesh.ppermute`: point-to-point sends
    (``dist.batch_isend_irecv``).
  * the all-gather that SPMD partitioning inserts where the owned slices
    of a vector become the replicated vector — `Mesh.all_gather`, over
    the whole mesh or one axis, along any dim.
  * ``jax.lax.all_to_all(..., split_axis=0, concat_axis=0, tiled=False)``
    over one axis — `Mesh.all_to_all` (``dist.all_to_all_single``).
  * ``jax.lax.psum_scatter(..., tiled=True)`` over one axis —
    `Mesh.reduce_scatter` (``dist.reduce_scatter_tensor``).

The `Mesh` methods do not differentiate.  The model path calls its
collectives through the functions at the end of this module, each a
``torch.autograd.Function`` whose backward is the transpose that jax's
``shard_map`` gives the collective where its output is read as the
model reads it:

  * `reduce_from` — psum forward, identity backward: the sum of
    row-parallel partial products, read the same way on every rank;
  * `copy_to` — identity forward, psum backward (Megatron's "f"): a
    replicated activation or leaf entering a split region, whose
    consumers on each rank give only their part of its gradient;
  * `reduce_both` — psum both ways: a psum whose output feeds split
    consumers (``tp_rmsnorm``'s sum of squares);
  * `gather_from` — all-gather forward, the rank's slice of the
    cotangent backward: the gathered tensor is read replicated;
  * `gather_shards` — all-gather over one or more axes forward,
    reduce-scatter (sum) backward: FSDP's parameter gather, each rank's
    gradient of the whole tensor summed into the shard's owner;
  * `exchange` — all-to-all both ways (its own transpose).

Without grad mode, or on a tensor that needs no gradient, each calls the
`Mesh` method directly (in place where the method is).

Layout: rank r of the group sits at position ``np.unravel_index(r,
shape)`` (row-major, as a jax ``Mesh`` over ``devices.reshape(shape)``).
For every axis of a mesh of more than one dimension, the ranks that differ
only along that axis form one subgroup.  ``dist.new_group`` is collective
over the whole world, so such a mesh (and every `Mesh.view` of it with
more than one dimension) is built on every rank of the default group, in
the same order.

A mesh without a group (`Mesh.local`) is a world of one: every collective
is the identity, as on a 1-device jax mesh.  A mesh with a group calls
``torch.distributed`` for every collective, also when the group holds one
rank: a CUDA mesh's group is NCCL and a CPU mesh's gloo, and a collective
that fails raises.  Each collective call issued is counted in
``obs.metrics`` (`ALL_REDUCE`, `ALL_GATHER`, `ALL_TO_ALL`,
`REDUCE_SCATTER`, `PPERMUTE`), in a backward pass too.

``torch.distributed`` is imported where a group is used, never when this
module is imported.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.csr import resolve_device
from repro_torch.obs import metrics

ALL_REDUCE = "mesh/all_reduce"
ALL_GATHER = "mesh/all_gather"
ALL_TO_ALL = "mesh/all_to_all"
REDUCE_SCATTER = "mesh/reduce_scatter"
PPERMUTE = "mesh/ppermute"


def _normal(dev: torch.device) -> torch.device:
    """``dev`` with the current CUDA index filled in."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Ranks of a process group laid out over named axes (module
    docstring).  ``group=None`` is a world of one on ``device``
    (None = CUDA, which must be present)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 group=None, device=None):
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if (len(self.shape) != len(self.axis_names) or not self.shape
                or min(self.shape) < 1
                or len(set(self.axis_names)) != len(self.axis_names)):
            raise ValueError(f"bad mesh shape {self.shape} / axes "
                             f"{self.axis_names}")
        self.device = _normal(resolve_device(device))
        self.group = group
        self.size = int(np.prod(self.shape))
        self._groups = {a: None for a in self.axis_names}
        if group is None:
            if self.size != 1:
                raise ValueError(f"a mesh of {self.size} ranks needs a "
                                 f"process group")
            self.rank = 0
            self._ranks = [0]
            return
        import torch.distributed as dist
        if dist.get_world_size(group) != self.size:
            raise ValueError(f"mesh shape {self.shape} has {self.size} "
                             f"ranks, the group {dist.get_world_size(group)}")
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if dist.get_backend(group) != want:
            raise ValueError(f"a {self.device.type} mesh needs a {want} "
                             f"group, got {dist.get_backend(group)}")
        self.rank = dist.get_rank(group)
        self._ranks = list(dist.get_process_group_ranks(group))
        if len(self.shape) == 1:
            self._groups[self.axis_names[0]] = group
            return
        grid = np.arange(self.size).reshape(self.shape)
        for i, axis in enumerate(self.axis_names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, self.shape[i]):
                sub = dist.new_group([self._ranks[r] for r in line])
                if self.rank in line:
                    self._groups[axis] = sub

    @classmethod
    def local(cls, axis_names: Sequence[str] = ("nodes",),
              device=None) -> "Mesh":
        """A world of one on ``device`` (None = CUDA)."""
        return cls((1,) * len(axis_names), axis_names, device=device)

    @classmethod
    def world(cls, axis_names: Sequence[str] = ("nodes",),
              shape: Optional[Sequence[int]] = None, device=None) -> "Mesh":
        """The default process group as a mesh; ``shape`` defaults to all
        of its ranks on one axis."""
        import torch.distributed as dist
        if shape is None:
            shape = (dist.get_world_size(),)
        return cls(shape, axis_names, group=dist.group.WORLD, device=device)

    def view(self, shape: Sequence[int],
             axis_names: Sequence[str]) -> "Mesh":
        """The same ranks, in the same order, under other axes (kahyparE
        turns its ``islands`` mesh into a ``("nets",)`` one)."""
        return Mesh(shape, axis_names, group=self.group, device=self.device)

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"rank={self.rank}, device={self.device})")

    # -- layout ------------------------------------------------------------
    def extent(self, axis: Optional[str]) -> int:
        """The axis's size (1 for ``axis=None``)."""
        return 1 if axis is None else self.shape[self._axis(axis)]

    def axis_index(self, axis: Optional[str]) -> int:
        """This rank's coordinate along ``axis`` (0 for ``axis=None``)."""
        if axis is None:
            return 0
        return int(np.unravel_index(self.rank, self.shape)[self._axis(axis)])

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no "
                             f"{axis!r}")
        return self.axis_names.index(axis)

    # -- collectives -------------------------------------------------------
    def _all_reduce(self, x: torch.Tensor, axis: Optional[str], op: str):
        if axis is None:
            return x
        self._axis(axis)                  # an unknown axis raises, as in jax
        if self.group is None:
            return x
        import torch.distributed as dist
        dist.all_reduce(x, op=getattr(dist.ReduceOp, op),
                        group=self._groups[axis])
        metrics.inc(ALL_REDUCE)
        return x

    def psum(self, x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        """Sum over ``axis`` (``None``: the identity).  Reduces the
        contiguous ``x`` in place and returns it."""
        return self._all_reduce(x, axis, "SUM")

    def pmax(self, x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        """Maximum over ``axis``, in place as `psum`."""
        return self._all_reduce(x, axis, "MAX")

    def pmin(self, x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        """Minimum over ``axis``, in place as `psum`."""
        return self._all_reduce(x, axis, "MIN")

    def agree(self, flag: bool) -> bool:
        """True on every rank exactly when ``flag`` is True on every rank
        (a MIN over the whole mesh)."""
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        if self.group is not None:
            import torch.distributed as dist
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
            metrics.inc(ALL_REDUCE)
        return bool(t.item())

    def all_gather(self, x: torch.Tensor, axis: Optional[str] = None,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (one shape on all ranks) concatenated along
        ``dim`` in rank order: over the whole mesh (``axis=None``), or
        over the ranks that differ from this one only along ``axis``."""
        if axis is not None:
            self._axis(axis)
        if self.group is None:
            return x
        import torch.distributed as dist
        x = x.contiguous()
        n = self.size if axis is None else self.extent(axis)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=(self.group if axis is None
                                         else self._groups[axis]))
        metrics.inc(ALL_GATHER)
        return torch.cat(parts, dim)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
        tiled=False)``: dim 0 of ``x`` (of size ``extent(axis)``) holds
        one block per rank of the axis; block j goes to the axis's rank j,
        and the result holds, at index i, what its rank i sent here."""
        self._axis(axis)
        if x.shape[0] != self.extent(axis):
            raise ValueError(f"all_to_all over {axis!r} needs dim 0 of "
                             f"size {self.extent(axis)}, got "
                             f"{tuple(x.shape)}")
        if self.group is None:
            return x
        import torch.distributed as dist
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self._groups[axis])
        metrics.inc(ALL_TO_ALL)
        return out

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int = 0) -> torch.Tensor:
        """The sum over ``axis`` of every rank's ``x``, of which this rank
        keeps its block along ``dim`` (block i on the axis's rank i; the
        dim must split into ``extent(axis)`` blocks)."""
        self._axis(axis)
        n = self.extent(axis)
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter over {axis!r}: dim {dim} of "
                             f"{tuple(x.shape)} does not split into {n}")
        if self.group is None:
            return x
        import torch.distributed as dist
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((xt.shape[0] // n,) + xt.shape[1:])
        # reduce_scatter_single is the newer name of reduce_scatter_tensor
        fn = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        fn(out, xt, group=self._groups[axis])
        metrics.inc(REDUCE_SCATTER)
        return out.movedim(0, dim)

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``jax.lax.ppermute`` on a 1-D mesh: for each pair of ``perm``
        the rank ``src`` sends ``x`` to the rank ``dst``; a rank that is
        no pair's ``dst`` gets zeros."""
        if len(self.shape) != 1:
            raise ValueError(f"ppermute needs a 1-D mesh, got {self.shape}")
        fwd = dict(perm)
        back = {d: s for s, d in perm}
        me = self.rank
        out = torch.zeros_like(x)
        if fwd.get(me) == me:
            out.copy_(x)
        if self.group is None:
            if any(s != d for s, d in perm):
                raise ValueError(f"a world of one cannot permute {perm}")
            return out
        import torch.distributed as dist
        x = x.contiguous()
        ops = []
        if me in fwd and fwd[me] != me:
            ops.append(dist.P2POp(dist.isend, x, self._ranks[fwd[me]],
                                  group=self.group))
        if me in back and back[me] != me:
            ops.append(dist.P2POp(dist.irecv, out, self._ranks[back[me]],
                                  group=self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            metrics.inc(PPERMUTE)
        return out


def check_mesh(mesh) -> None:
    """Raise TypeError unless ``mesh`` is None or a `Mesh`: a foreign mesh
    (a jax ``Mesh``, a stand-in object) is refused, never ignored."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.core.mesh.Mesh or "
                        f"None, got {type(mesh).__name__}")


def device_of(mesh: Optional[Mesh], device=None) -> torch.device:
    """The device of an entry point called with ``mesh`` and ``device``:
    the mesh's own (``device``, when given, must name it), else
    ``resolve_device(device)``."""
    check_mesh(mesh)
    if mesh is None:
        return resolve_device(device)
    if device is not None and _normal(resolve_device(device)) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


# ---------------------------------------------------------------------------
# collectives with a backward (module docstring)
# ---------------------------------------------------------------------------

def _axes(axes) -> tuple:
    return axes if isinstance(axes, tuple) else (axes,)


def _slice(mesh: Mesh, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (the first
    axis the slowest), as `gather_shards` lays the blocks out."""
    i, n = 0, 1
    for a in _axes(axes):
        i, n = i * mesh.extent(a) + mesh.axis_index(a), n * mesh.extent(a)
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size).contiguous()


def _gather(mesh: Mesh, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    for a in reversed(_axes(axes)):
        x = mesh.all_gather(x, a, dim=dim)
    return x


def _scatter(mesh: Mesh, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    for a in _axes(axes):
        x = mesh.reduce_scatter(x, a, dim=dim)
    return x


def _psum(mesh: Mesh, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    x = x.contiguous().clone()
    for a in _axes(axes):
        mesh.psum(x, a)
    return x


_RULES = {"id": lambda mesh, x, axes, dim: x.view_as(x),
          "psum": _psum,
          "gather": _gather,
          "slice": _slice,
          "scatter": _scatter,
          "a2a": lambda mesh, x, axes, dim: mesh.all_to_all(x, axes)}


class _Collective(torch.autograd.Function):
    """``fwd`` of `_RULES` forward, ``bwd`` backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, fwd, bwd):
        ctx.rule = (mesh, axes, dim, bwd)
        return _RULES[fwd](mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, bwd = ctx.rule
        return _RULES[bwd](mesh, g, axes, dim), None, None, None, None, None


def _run(mesh: Mesh, x: torch.Tensor, axes, dim: int, fwd: str,
         bwd: str, in_place: bool = False) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Collective.apply(x, mesh, axes, dim, fwd, bwd)
    if in_place:                  # the Mesh method, on x itself
        x = x.contiguous()
        for a in _axes(axes):
            x = mesh.psum(x, a)
        return x
    return _RULES[fwd](mesh, x, axes, dim)


def reduce_from(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """psum over ``axis``; backward: the identity."""
    return _run(mesh, x, axis, 0, "psum", "id", in_place=True)


def copy_to(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """The identity; backward: psum over ``axis``."""
    return _run(mesh, x, axis, 0, "id", "psum")


def reduce_both(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """psum over ``axis``; backward: psum over ``axis``."""
    return _run(mesh, x, axis, 0, "psum", "psum", in_place=True)


def gather_from(mesh: Mesh, x: torch.Tensor, axis: str,
                dim: int) -> torch.Tensor:
    """All-gather over ``axis`` along ``dim``; backward: the rank's
    slice of the cotangent."""
    return _run(mesh, x, axis, dim, "gather", "slice")


def gather_shards(mesh: Mesh, x: torch.Tensor, axes,
                  dim: int) -> torch.Tensor:
    """All-gather over ``axes`` (a name or a tuple, the first the
    slowest) along ``dim``; backward: reduce-scatter (sum) over them."""
    return _run(mesh, x, axes, dim, "gather", "scatter")


def exchange(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """`Mesh.all_to_all` over ``axis``; backward: the same all-to-all."""
    return _run(mesh, x, axis, 0, "a2a", "a2a")
