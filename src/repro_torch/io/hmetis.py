"""hMETIS text hypergraph format (the format KaHyPar/hMetis consume).

Header: ``m n [fmt]`` — number of nets FIRST, then vertices.  ``fmt`` is
``1`` (net weights), ``10`` (vertex weights) or ``11`` (both).  Each of the
next m lines lists one net: ``[w] pin pin ...`` with 1-indexed pins.  When
vertex weights are present they follow as n single-number lines.  ``%``
lines are comments.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hypergraph.container import (Hypergraph,
                                                   HypergraphFormatError)


def read_hmetis(path: str) -> Hypergraph:
    with open(path, "r") as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.strip().startswith("%")]
    if not lines:
        raise HypergraphFormatError("empty hypergraph file")
    head = lines[0].split()
    if len(head) not in (2, 3):
        raise HypergraphFormatError(f"bad header: {lines[0]!r}")
    m, n = int(head[0]), int(head[1])
    fmt = head[2] if len(head) == 3 else "0"
    has_ew = fmt.endswith("1")
    has_vw = len(fmt) >= 2 and fmt[-2] == "1"
    want = 1 + m + (n if has_vw else 0)
    if len(lines) != want:
        raise HypergraphFormatError(
            f"expected {want} non-comment lines, got {len(lines)}")
    ewgt = np.ones(m, dtype=np.int64)
    nets = []
    for e in range(m):
        tok = [int(t) for t in lines[1 + e].split()]
        if has_ew:
            if len(tok) < 2:
                raise HypergraphFormatError(f"net {e + 1}: missing weight/pins")
            ewgt[e] = tok[0]
            tok = tok[1:]
        if not tok:
            raise HypergraphFormatError(f"net {e + 1}: empty net")
        nets.append([t - 1 for t in tok])
    vwgt = None
    if has_vw:
        vwgt = np.asarray([int(lines[1 + m + v]) for v in range(n)],
                          dtype=np.int64)
    hg = Hypergraph.from_nets(n, nets, ewgt=ewgt, vwgt=vwgt,
                              dedup_pins=False)
    hg.check()
    return hg


def write_hmetis(hg: Hypergraph, path: str) -> None:
    has_vw = not np.all(hg.vwgt == 1)
    has_ew = not np.all(hg.ewgt == 1)
    fmt = f"{int(has_vw)}{int(has_ew)}"
    with open(path, "w") as f:
        head = f"{hg.m} {hg.n}"
        if fmt != "00":
            head += f" {fmt.lstrip('0')}"
        f.write(head + "\n")
        for e in range(hg.m):
            parts = []
            if has_ew:
                parts.append(str(int(hg.ewgt[e])))
            parts.extend(str(int(p) + 1) for p in hg.net_pins(e))
            f.write(" ".join(parts) + "\n")
        if has_vw:
            for v in range(hg.n):
                f.write(f"{int(hg.vwgt[v])}\n")


def hypergraphchecker(path: str) -> list:
    """Returns [] iff the file parses and validates cleanly; otherwise the
    list of errors.  Never raises on a malformed or unreadable file."""
    try:
        hg = read_hmetis(path)
    except (HypergraphFormatError, ValueError, OSError) as e:
        return [str(e)]
    return hg.check(raise_on_error=False)
