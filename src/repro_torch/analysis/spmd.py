"""SPMD replication checker, at run time (port of
``repro/analysis/spmd.py``).

The reference walks every ``shard_map`` body of an entry's jaxpr with a
dataflow analysis of which mesh axes each value varies over, and flags a
body output whose varying set exceeds what ``out_specs`` claims: with
``check_vma=False`` each shard would silently hold a different value.  It
also flags a collective over an axis the mesh lacks.

The port has no traced body.  A collective over an unknown axis already
raises at run time (``Mesh._axis``, `core/mesh.py`).  What is left is the
replication claim itself, and it is checked where it can be observed: every
rank of the mesh runs the entry (``EntryPoint.build(device, mesh)``) on its
own shard, hashes each output the protocol claims every rank holds alike
(``EntryPoint.replicated``), and all-gathers the hashes.  Ranks that
disagree make a ``varying-as-replicated`` finding that names the axes the
output varies over: the axes along which two ranks that differ only in
that coordinate hold different hashes.  Every rank returns the same
findings.

On a world of one (no mesh given) the check runs the protocol on a
`Mesh.local` of the entry's axes, where it cannot fail; the multi-rank
check runs on ranks that ``torch.distributed`` joins (the tests' gloo
ranks, or one per card).
"""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np
import torch

from repro_torch.analysis.findings import Finding


def digest(value) -> int:
    """A 63-bit hash of an output's dtype, shape and bytes."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(value))
    h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
    h.update(a.tobytes())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def varying_axes(hashes: np.ndarray, shape, axis_names) -> List[str]:
    """The axes along which ``hashes`` (one per rank, row-major over
    ``shape``) differ between ranks that share every other coordinate."""
    grid = np.asarray(hashes).reshape(shape)
    out = []
    for i, axis in enumerate(axis_names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        if any(len(set(line.tolist())) > 1 for line in lines):
            out.append(axis)
    return out


def check_spmd(entry, mesh=None, device=None) -> List[Finding]:
    """Run ``entry`` on ``mesh`` (None: a world of one over its
    ``mesh_axes`` on ``device``) and hold its replicated outputs equal on
    every rank."""
    from repro_torch.core.mesh import Mesh
    if entry.replicated is None:
        return []
    if mesh is None:
        mesh = Mesh.local(entry.mesh_axes, device)
    fn, args = entry.build(mesh.device, mesh)
    claimed = entry.replicated(fn(*args))
    findings: List[Finding] = []
    for name, value in claimed.items():
        mine = torch.tensor([digest(value)], dtype=torch.int64,
                            device=mesh.device)
        hashes = mesh.all_gather(mine).cpu().numpy()
        axes = varying_axes(hashes, mesh.shape, mesh.axis_names)
        if not axes:
            continue
        findings.append(Finding(
            checker="spmd", severity="error", entry=entry.name,
            code="varying-as-replicated", location=f"{entry.name}.{name}",
            message=f"output {name} of {entry.name} differs between ranks "
                    f"along {axes} of the mesh {mesh.shape} although the "
                    f"protocol claims every rank holds it alike — a "
                    f"collective over {axes} is missing",
            detail={"varying": axes, "claimed": [],
                    "distinct": int(len(set(hashes.tolist())))}))
    return findings
