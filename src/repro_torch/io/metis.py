"""Metis / Chaco / DIMACS-challenge text graph format (paper §3.1.1)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import Graph, GraphFormatError


def read_metis(path: str) -> Graph:
    """Parse the Metis text format. 1-indexed vertices, % comments.

    Empty lines after the header are kept — an isolated vertex is stored as
    an empty line.
    """
    with open(path, "r") as f:
        raw = [l.strip() for l in f if not l.strip().startswith("%")]
    # header = first non-empty line; everything after it is a vertex line
    while raw and not raw[0]:
        raw.pop(0)
    lines = raw
    if not lines:
        raise GraphFormatError("empty graph file")
    head = lines[0].split()
    if len(head) not in (2, 3):
        raise GraphFormatError(f"bad header: {lines[0]!r}")
    n, m = int(head[0]), int(head[1])
    fmt = head[2] if len(head) == 3 else "0"
    has_ew = fmt.endswith("1")
    has_vw = len(fmt) >= 2 and fmt[-2] == "1"
    while len(lines) - 1 > n and not lines[-1]:
        lines.pop()                      # trailing blank lines at EOF
    if len(lines) - 1 != n:
        raise GraphFormatError(f"expected {n} vertex lines, got {len(lines) - 1}")
    xadj = np.zeros(n + 1, dtype=np.int64)
    adjncy, adjwgt = [], []
    vwgt = np.ones(n, dtype=np.int64)
    for i in range(n):
        tok = [int(t) for t in lines[1 + i].split()]
        p = 0
        if has_vw:
            if not tok:
                raise GraphFormatError(f"vertex {i + 1}: missing weight")
            vwgt[i] = tok[0]
            p = 1
        rest = tok[p:]
        if has_ew:
            if len(rest) % 2:
                raise GraphFormatError(f"vertex {i + 1}: odd token count with edge weights")
            adjncy.extend(r - 1 for r in rest[0::2])
            adjwgt.extend(rest[1::2])
            xadj[i + 1] = xadj[i] + len(rest) // 2
        else:
            adjncy.extend(r - 1 for r in rest)
            adjwgt.extend([1] * len(rest))
            xadj[i + 1] = xadj[i] + len(rest)
    adjncy = np.asarray(adjncy, dtype=np.int64)
    adjwgt = np.asarray(adjwgt, dtype=np.int64)
    if len(adjncy) != 2 * m:
        raise GraphFormatError(
            f"header says m={m} (=> {2 * m} directed edges) but file has {len(adjncy)}")
    g = Graph(xadj=xadj, adjncy=adjncy, vwgt=vwgt, adjwgt=adjwgt)
    return g


def write_metis(g: Graph, path: str) -> None:
    has_vw = not np.all(g.vwgt == 1)
    has_ew = not np.all(g.adjwgt == 1)
    fmt = f"{int(has_vw)}{int(has_ew)}"
    with open(path, "w") as f:
        head = f"{g.n} {g.m}"
        if fmt != "00":
            head += f" {fmt.lstrip('0') if fmt != '10' else '10'}"
        f.write(head + "\n")
        for v in range(g.n):
            parts = []
            if has_vw:
                parts.append(str(int(g.vwgt[v])))
            nb = g.neighbors(v)
            ew = g.edge_weights(v)
            for j in range(len(nb)):
                parts.append(str(int(nb[j]) + 1))
                if has_ew:
                    parts.append(str(int(ew[j])))
            f.write(" ".join(parts) + "\n")


def graphchecker(path: str) -> list:
    """The ``graphchecker`` program: returns [] iff the file is valid."""
    try:
        g = read_metis(path)
    except GraphFormatError as e:
        return [str(e)]
    return g.check(raise_on_error=False)


# -- output formats (§3.2) ---------------------------------------------------

def write_separator(part: np.ndarray, sep_ids: np.ndarray, k: int,
                    path: str) -> None:
    """Separator format: separator nodes get block id k, others keep theirs."""
    out = np.asarray(part, dtype=np.int64).copy()
    out[np.asarray(sep_ids, dtype=np.int64)] = k
    np.savetxt(path, out, fmt="%d")


def read_separator(path: str, k: int):
    """Inverse of ``write_separator``: returns (part, sep_ids).

    Vertices labelled ``k`` are the separator; their ``part`` entry is reset
    to block 0 (the information the format drops).  ``k`` is required
    because the format does not encode it — inferring it from the maximum
    label would misread an empty-separator file (max label k−1) as having
    the whole top block in the separator.
    """
    raw = np.loadtxt(path, dtype=np.int64, ndmin=1)
    if len(raw) and raw.max() > k:
        raise GraphFormatError(
            f"separator file has label {int(raw.max())} > k={k}")
    sep_ids = np.flatnonzero(raw == k)
    part = raw.copy()
    part[sep_ids] = 0
    return part, sep_ids
