"""`repro_torch.analysis` — the contract checks on the port's device
programs (port of ``repro/analysis``).

The reference traces every registered entry point to a jaxpr and checks
the program.  The port has no traced program, so its checkers *run* each
entry eagerly on a canonical tiny instance (`registry.py`), on the CPU or
on the card:

  * **padding**  — padding-inertness by self-composition (padding.py):
    garbage in the padding slots leaves the real outputs bit-identical;
    on CUDA tensors this checks the hand-written kernels;
  * **spmd**     — the outputs a distributed protocol claims replicated
    are equal on every rank (spmd.py);
  * **hygiene**  — host syncs and float64 ops in the entry's op trace
    (tracing.py, checkers.py);

plus two source lints: **host_sync** (serve path) and **registry**
(driver coverage).  ``python -m repro_torch.analysis`` runs everything,
writes an obs-journal-compatible findings JSONL and exits 1 on any
finding: the port gates at zero.  The reference's ``bucket`` checker and
its ``note_program`` seeding have no counterpart (checkers.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch import obs
from repro_torch.analysis.findings import (CHECKERS, Finding, load_baseline,
                                           partition_by_baseline,
                                           write_findings_jsonl)
from repro_torch.analysis.registry import (DRIVER_ENTRIES, EntryPoint,
                                           PaddingSpec, default_registry)
from repro_torch.core.csr import resolve_device

__all__ = [
    "CHECKERS", "DRIVER_ENTRIES", "EntryPoint", "Finding", "PaddingSpec",
    "analyze", "analyze_entry", "default_registry", "exercise_drivers",
    "load_baseline", "partition_by_baseline", "write_findings_jsonl",
]


def analyze_entry(entry: EntryPoint, device=None, mesh=None,
                  traces: Optional[dict] = None) -> List[Finding]:
    """Run one entry point on ``device`` (None: the card, raising without
    one) under every checker its tags request (spmd on ``mesh``, None: a
    world of one).  ``traces``, where given, receives the entry's
    `tracing.TracedEntry`."""
    from repro_torch.analysis import checkers, padding, spmd, tracing
    device = resolve_device(device)
    try:
        traced = tracing.trace_entry(entry, device)
    except Exception as exc:  # noqa: BLE001 — any run failure is a finding
        return [Finding(
            checker="hygiene", severity="error", entry=entry.name,
            code="trace-error", location="trace",
            message=f"{entry.name} failed to run: "
                    f"{type(exc).__name__}: {exc}")]
    if traces is not None:
        traces[entry.name] = traced
    out: List[Finding] = []
    if "hygiene" in entry.tags:
        out.extend(checkers.check_hygiene(traced, entry))
        out.extend(checkers.check_launches(traced, entry, device))
    if "spmd" in entry.tags:
        out.extend(spmd.check_spmd(entry, mesh, device))
    if "padding" in entry.tags:
        try:
            out.extend(padding.check_padding(entry, device))
        except Exception as exc:  # noqa: BLE001
            out.append(Finding(
                checker="padding", severity="error", entry=entry.name,
                code="eval-error", location="eval",
                message=f"{entry.name} padding self-composition failed to "
                        f"evaluate: {type(exc).__name__}: {exc}"))
    return out


def exercise_drivers(device=None) -> None:
    """Tiny end-to-end driver calls on ``device`` (None: the card): the
    public paths the registry's entries sit on, run once (the reference
    runs them to seed its ``note_program`` signatures, which the port does
    not have)."""
    from repro_torch.core import interface as I
    device = resolve_device(device)
    from repro_torch.analysis.registry import _ring_graph, _tiny_hypergraph
    g = _ring_graph()
    I.kaffpa(g.n, g.vwgt, g.xadj, g.adjwgt, g.adjncy, 2, 0.1, seed=0,
             mode=I.FAST, device=device)
    hg = _tiny_hypergraph()
    I.kahypar(hg.n, hg.m, hg.vwgt, hg.ewgt, hg.eptr, hg.eind, 2, 0.1,
              seed=0, mode=I.FAST, device=device)
    I.node_separator(g.n, g.vwgt, g.xadj, g.adjwgt, g.adjncy, 2, 0.2,
                     seed=0, mode=I.FAST, device=device)


def analyze(entries: Optional[Sequence[str]] = None,
            registry: Optional[Dict[str, EntryPoint]] = None,
            lints: bool = True, device=None,
            traces: Optional[dict] = None) -> List[Finding]:
    """Run every checker on ``device`` (None: the card, raising without
    one); returns findings (counters land in ``obs.metrics``)."""
    from repro_torch.analysis import lint
    device = resolve_device(device)
    registry = default_registry() if registry is None else registry
    names = sorted(registry) if entries is None else list(entries)
    findings: List[Finding] = []
    for name in names:
        findings.extend(analyze_entry(registry[name], device,
                                      traces=traces))
    if lints:
        findings.extend(lint.check_host_sync())
        findings.extend(lint.check_driver_registry())
    per_checker: Dict[str, int] = {}
    for f in findings:
        per_checker[f.checker] = per_checker.get(f.checker, 0) + 1
    obs.metrics.inc("analysis/violations", len(findings))
    for c, n in per_checker.items():
        obs.metrics.inc(f"analysis/{c}", n)
    return findings
