"""Findings: the unit of output of every checker in `repro_torch.analysis`
(port of ``repro/analysis/findings.py``).

A finding is one contract violation (or suspicious construct) at one
location in one entry point's run.  Findings serialise to a JSONL file in
the `repro_torch.obs` journal format: a ``kind: "recorder"`` header line
followed by one event line per finding, so ``obs.read_jsonl`` parses a
findings file exactly like a trace journal.

The port gates at **zero findings**.  It keeps `load_baseline` and
`partition_by_baseline` for files in the reference's format, but has no
baseline file of its own: a finding that is allowed is allowed in the
registry entry that produces it (`registry.EntryPoint.allow_syncs`), with
its reason beside it.

The reference's ``bucket`` checker has no counterpart (module docstring of
`repro_torch.analysis.checkers`), so ``bucket`` is not in `CHECKERS`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning", "info")

#: checker identifiers: the three run-time checkers and the two lints
CHECKERS = (
    "padding",       # padding-inertness (the zero-weight mask contract)
    "spmd",          # replication of the outputs the protocol claims
    "hygiene",       # host syncs and float64 ops in an entry's op trace
    "host_sync",     # AST lint: host syncs on the serve path
    "registry",      # entry-point registry coverage lint
)


@dataclasses.dataclass(frozen=True)
class Finding:
    checker: str            # one of CHECKERS
    severity: str           # one of SEVERITIES
    entry: str              # registry entry name ("" for tree-wide lints)
    code: str               # short machine code, e.g. "host-sync"
    location: str           # source site ("core/refine.py:fn") or file:line
    message: str            # human sentence
    detail: Optional[dict] = None

    def __post_init__(self):
        assert self.checker in CHECKERS, self.checker
        assert self.severity in SEVERITIES, self.severity

    @property
    def key(self) -> str:
        """Stable identity for baseline matching: everything except the
        message text (messages may carry volatile values like shapes)."""
        return f"{self.checker}:{self.entry}:{self.code}:{self.location}"

    def to_event(self) -> dict:
        ev = {
            "rec": "analysis",
            "kind": "finding",
            "checker": self.checker,
            "severity": self.severity,
            "entry": self.entry,
            "code": self.code,
            "location": self.location,
            "message": self.message,
            "key": self.key,
        }
        if self.detail:
            ev["detail"] = self.detail
        return ev


def write_findings_jsonl(path: str, findings: Sequence[Finding]) -> None:
    """Write findings in the obs journal format: recorder header + events.

    ``obs.read_jsonl(path)`` returns ``([header], [finding events])``.
    """
    per_checker: Dict[str, int] = {}
    for f in findings:
        per_checker[f.checker] = per_checker.get(f.checker, 0) + 1
    header = {
        "kind": "recorder",
        "name": "analysis",
        "counters": {f"analysis/{c}": n
                     for c, n in sorted(per_checker.items())},
        "trajectories": {},
    }
    with open(path, "w") as fh:
        fh.write(json.dumps(header) + "\n")
        for f in findings:
            fh.write(json.dumps(f.to_event()) + "\n")


def load_baseline(path: str) -> Dict[str, str]:
    """Baseline file -> {finding key: reason}.  Missing file = empty."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return {}
    assert doc.get("version") == 1, f"unknown baseline version in {path}"
    out: Dict[str, str] = {}
    for entry in doc.get("allow", []):
        out[entry["key"]] = entry.get("reason", "")
    return out


def partition_by_baseline(
    findings: Iterable[Finding], baseline: Dict[str, str]
) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (new, baselined)."""
    new: List[Finding] = []
    allowed: List[Finding] = []
    for f in findings:
        (allowed if f.key in baseline else new).append(f)
    return new, allowed
