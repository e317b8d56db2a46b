"""Hygiene checks on an entry's op trace (port of
``repro/analysis/checkers.py``).

The reference's ``check_hygiene`` walks a jaxpr for callbacks in scan
bodies, float64 avals and weak-typed carries.  Its port reads the op trace
of one eager run (`tracing.trace_entry`) and makes two checks:

  * **host syncs** — every read of a tensor back to the host
    (``aten._local_scalar_dense``, the op behind ``.item()``, ``int(t)``
    and ``bool(t)``; ``.cpu()``, ``.tolist()``; device-to-host copies) at
    a site the entry does not allow (``EntryPoint.allow_syncs``, with its
    reason, plays the part of the reference's ``allow_callbacks``): one
    read per call is a ``host-sync`` warning, more than one at one site
    (a read per round or per layer) a ``sync-in-loop`` error;
  * **wide dtypes** — any op producing float64 or complex128
    (``_BAD_DTYPES`` in the reference): the engine is f32/int32.

On a CUDA run, an entry whose ``kernels`` counters did not rise ran no
hand-written kernel: ``kernel-not-launched``.

What has no counterpart is not ported:

  * ``check_bucket`` and ``check_program_registry`` — the port compiles no
    programs, so nothing recompiles per shape, and it has no pow2 batch
    floor or rounds bucket (PR 11): there is no bucket to hold;
  * weak-type promotion — torch tensors have no weak types, and a Python
    scalar in a torch expression takes the tensor's dtype.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.tracing import TracedEntry


def check_hygiene(traced: TracedEntry, entry) -> List[Finding]:
    out: List[Finding] = []
    sites: Dict[str, list] = {}
    for s in traced.syncs:
        sites.setdefault(s.site.location, []).append(s)
    for loc, syncs in sorted(sites.items()):
        if entry.allowed(loc) is not None:
            continue
        lines = sorted({s.site.line for s in syncs})
        whats = sorted({s.what for s in syncs})
        many = len(syncs) > 1
        out.append(Finding(
            checker="hygiene", severity="error" if many else "warning",
            entry=entry.name, code="sync-in-loop" if many else "host-sync",
            location=loc,
            message=f"{len(syncs)} host read(s) ({', '.join(whats)}) at "
                    f"{loc} lines {lines} in one call of {entry.name} — "
                    f"each waits for the card (allow it in the entry's "
                    f"allow_syncs, with its reason, if it is designed)",
            detail={"reads": len(syncs), "lines": lines, "what": whats}))
    seen = set()
    for op, dtype, site in traced.wide:
        loc = f"{site.location}:{op}"
        if loc in seen:
            continue
        seen.add(loc)
        out.append(Finding(
            checker="hygiene", severity="error", entry=entry.name,
            code="wide-dtype", location=loc,
            message=f"{dtype} value produced by {op} at {site.file}:"
                    f"{site.line} in {entry.name} — the engine is strictly "
                    f"f32/int32"))
    return out


def check_launches(traced: TracedEntry, entry, device) -> List[Finding]:
    """On a CUDA run: every kernel the entry names launched."""
    import torch
    if torch.device(device).type != "cuda":
        return []
    return [Finding(
        checker="hygiene", severity="error", entry=entry.name,
        code="kernel-not-launched", location=name,
        message=f"{entry.name} on the card did not launch its kernel "
                f"({name} rose by {n:g})")
        for name, n in sorted(traced.launches.items()) if n <= 0]
