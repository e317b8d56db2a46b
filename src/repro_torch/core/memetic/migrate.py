"""Rumor-spreading migration (the memetic engine's exchange).

Every migration round each island pushes its best individual's partition
vector one ring step of ``shift`` islands: island i receives from island
(i - shift) mod I.  A seeded random shift per round is the randomized
rumor-spreading exchange of the paper's MPI formulation, restated as a
static permutation of the stacked (I, n) best-parts matrix.

This package runs every island in one process, so the ring is a host
roll.  Laying the islands out over several devices (a block exchange
between ranks per round) belongs to the distributed programs, ROADMAP.md
queue 1 item 9; until then a mesh is refused, never ignored.
"""
from __future__ import annotations

import numpy as np


def refuse_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None (see the module docstring)."""
    if mesh is not None:
        raise NotImplementedError(
            "island meshes wait for the distributed programs (ROADMAP.md "
            "queue 1 item 9); pass mesh=None")


def ring_roll_host(parts: np.ndarray, shift: int) -> np.ndarray:
    """out[i] = parts[(i - shift) mod I]."""
    parts = np.asarray(parts)
    return np.roll(parts, shift % len(parts), axis=0)


def ring_roll(parts: np.ndarray, shift: int, mesh=None) -> np.ndarray:
    """Ring-migrate the (I, n) best-parts matrix by ``shift`` islands
    (int32 out).  ``mesh`` must be None: see the module docstring."""
    refuse_mesh(mesh)
    parts = np.asarray(parts, dtype=np.int32)
    shift %= parts.shape[0]
    if shift == 0:
        return parts.copy()
    return ring_roll_host(parts, shift)
