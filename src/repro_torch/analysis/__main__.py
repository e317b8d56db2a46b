"""CLI: ``python -m repro_torch.analysis`` — run every checker, write the
findings JSONL, exit 1 on any finding (the port gates at zero).

    python -m repro_torch.analysis [--device cpu|cuda] [--entries a,b]
                                   [--list] [--out FILE] [--no-exercise]

The default device is the card (``cuda``): as every entry point of the
port, it raises without one unless ``--device cpu`` is given.  On the
card the padding runs launch the hand-written kernels.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from repro_torch import obs
from repro_torch.analysis import (analyze, default_registry, exercise_drivers,
                                  write_findings_jsonl)
from repro_torch.analysis.findings import Finding


def _fmt(f: Finding) -> str:
    return (f"  [{f.severity:7s}] {f.checker:9s} {f.entry or '-':28s} "
            f"{f.code:26s} {f.location}\n      {f.message}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the entries run (default: the card)")
    ap.add_argument("--out", default="analysis_findings_torch.jsonl",
                    help="findings JSONL (obs read_jsonl compatible)")
    ap.add_argument("--entries", default=None,
                    help="comma-separated entry names (default: all)")
    ap.add_argument("--list", action="store_true",
                    help="list registered entry points and exit")
    ap.add_argument("--no-exercise", action="store_true",
                    help="skip the tiny end-to-end driver runs")
    args = ap.parse_args(argv)

    registry = default_registry()
    if args.list:
        for name, e in sorted(registry.items()):
            print(f"{name:28s} tags={','.join(sorted(e.tags))}"
                  + (f" drivers={','.join(e.drivers)}" if e.drivers else ""))
        return 0

    from repro_torch.core.csr import resolve_device
    device = resolve_device(args.device)        # raises without a card
    if not args.no_exercise:
        exercise_drivers(device)
    entries = args.entries.split(",") if args.entries else None
    traces: dict = {}
    findings: List[Finding] = analyze(entries=entries, device=device,
                                      traces=traces)
    write_findings_jsonl(args.out, findings)
    obs.metrics.set_gauge("analysis/new_violations", len(findings))
    checked = sorted(registry) if entries is None else entries
    print(f"repro_torch.analysis on {device}: {len(checked)} entry points, "
          f"{len(findings)} findings -> {args.out}")
    for name, t in sorted(traces.items()):
        sites = t.sync_sites()
        allowed = {loc: n for loc, n in sites.items()
                   if registry[name].allowed(loc) is not None}
        print(f"  {name:28s} {len(t.ops):6d} ops, host reads per call "
              f"{sum(sites.values())} (allowed {allowed or '{}'})")
    if findings:
        print("findings:")
        for f in findings:
            print(_fmt(f))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
