"""Rumor-spreading migration as a collective (the memetic engine's
exchange).

Every migration round each island pushes its best individual's partition
vector one ring step of ``shift`` islands: island i receives from island
(i - shift) mod I.  A seeded random shift per round is the randomized
rumor-spreading exchange of the paper's MPI formulation, restated as a
*static* permutation so it maps onto `Mesh.ppermute` when the islands are
laid out over the ranks of an ``islands`` mesh.

Every rank runs the whole island loop with the same seeds, so every rank
holds the whole stacked best-parts matrix (I, n); only the migration
exchanges blocks (the torch form of jax's single controller).  Rank d
owns islands [d·ipd, (d+1)·ipd) with ``ipd = I / S``; a global ring roll
of island rows decomposes into at most two `Mesh.ppermute` block exchanges
plus an intra-rank reorder: with ``shift = q·ipd + r``, destination rank d
needs rows from source ranks (d-q) and (d-q-1) — block A shifted q ranks
forward supplies local rows r.., block B shifted q+1 supplies rows ..r.
The rolled blocks are then all-gathered back into the replicated matrix.
With one rank both permutes are the identity and the reorder is exactly
the host ``np.roll``; the host roll also serves meshes whose rank count
does not divide the island count.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mesh import Mesh, check_mesh

AXIS = "islands"


def islands_mesh(mesh: Mesh) -> Mesh:
    """The ranks of ``mesh``, in order, as a 1-D ``islands`` mesh."""
    check_mesh(mesh)
    return mesh.view((mesh.size,), (AXIS,))


def ring_roll_host(parts: np.ndarray, shift: int) -> np.ndarray:
    """out[i] = parts[(i - shift) mod I]."""
    parts = np.asarray(parts)
    return np.roll(parts, shift % len(parts), axis=0)


def _ring_roll_mesh(mesh: Mesh, parts: np.ndarray, shift: int) -> np.ndarray:
    n_sh = mesh.size
    ipd = parts.shape[0] // n_sh
    q, r = divmod(shift, ipd)
    me = mesh.rank
    block = torch.from_numpy(parts[me * ipd:(me + 1) * ipd]).to(mesh.device)
    a = mesh.ppermute(block, [(s, (s + q) % n_sh) for s in range(n_sh)])
    if r:
        b = mesh.ppermute(block, [(s, (s + q + 1) % n_sh)
                                  for s in range(n_sh)])
        a = torch.cat([b[ipd - r:], a[:ipd - r]])
    return mesh.all_gather(a).cpu().numpy()


def ring_roll(parts: np.ndarray, shift: int, mesh=None) -> np.ndarray:
    """Ring-migrate the (I, n) best-parts matrix by ``shift`` islands
    (int32 out).

    With a mesh whose rank count divides I the roll runs as block
    exchanges over the ranks (the mesh is read as an ``islands`` mesh);
    otherwise, or with ``mesh=None``, the host roll computes the identical
    result.  Every rank calls it with the same matrix and shift.
    """
    check_mesh(mesh)
    parts = np.asarray(parts, dtype=np.int32)
    n_isl = parts.shape[0]
    shift %= n_isl
    if shift == 0:
        return parts.copy()
    if mesh is None or n_isl % mesh.size != 0:
        return ring_roll_host(parts, shift)
    return _ring_roll_mesh(islands_mesh(mesh), parts, shift)
