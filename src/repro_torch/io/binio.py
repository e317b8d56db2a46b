"""ParHIP binary graph format (paper §3.1.2).

Layout (all 64-bit unsigned little-endian longs):
  [version=3][n][m_directed]                      -- 3 words
  [off_0 .. off_n]                                -- n+1 BYTE offsets; off_i is
                                                     the file position where the
                                                     edge targets of vertex i
                                                     start; off_n marks EOF
  [targets...]                                    -- one u64 per directed edge

Node ids start at 0. ``graph2binary`` / ``graph2binary_external`` convert the
Metis text format; the external variant streams row-by-row without holding the
adjacency in memory (paper §4.3.2). ``toolbox`` helpers live in metis.py.
The files are byte-identical to the JAX package's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import Graph, GraphFormatError
from repro_torch.io.metis import read_metis

_VERSION = 3
_W = 8  # bytes per word


def write_binary(g: Graph, path: str) -> None:
    n, e = g.n, len(g.adjncy)
    header = np.array([_VERSION, n, e], dtype=np.uint64)
    base = (3 + n + 1) * _W
    offsets = (base + g.xadj.astype(np.uint64) * _W).astype(np.uint64)
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(offsets.tobytes())
        f.write(g.adjncy.astype(np.uint64).tobytes())


def read_binary(path: str) -> Graph:
    with open(path, "rb") as f:
        head = np.frombuffer(f.read(3 * _W), dtype=np.uint64)
        if len(head) != 3:
            raise GraphFormatError("truncated binary header")
        version, n, e = int(head[0]), int(head[1]), int(head[2])
        if version != _VERSION:
            raise GraphFormatError(f"unsupported binary version {version}")
        offsets = np.frombuffer(f.read((n + 1) * _W), dtype=np.uint64).astype(np.int64)
        targets = np.frombuffer(f.read(e * _W), dtype=np.uint64).astype(np.int64)
    base = (3 + n + 1) * _W
    xadj = (offsets - base) // _W
    if xadj[0] != 0 or xadj[-1] != e:
        raise GraphFormatError("inconsistent binary offsets")
    return Graph.from_arrays(xadj, targets)


def graph2binary(metis_path: str, out_path: str) -> None:
    write_binary(read_metis(metis_path), out_path)


def _metis_lines(f):
    """A Metis file's header line, then its vertex lines, as ``read_metis``
    reads them: comments dropped, blank lines before the header skipped,
    and a blank line after it an isolated vertex."""
    lines = (l.strip() for l in f)
    lines = (l for l in lines if not l.startswith("%"))
    for line in lines:
        if line:
            yield line
            break
    yield from lines


def graph2binary_external(metis_path: str, out_path: str) -> None:
    """External-memory converter: two streaming passes, O(n) resident.
    Unlike the JAX package's, it reads an isolated vertex's blank line
    (the JAX package's skips it and runs out of lines)."""
    # pass 1: degrees only
    degs = []
    with open(metis_path) as f:
        body = _metis_lines(f)
        head = next(body).split()
        n, m = int(head[0]), int(head[1])
        fmt = head[2] if len(head) == 3 else "0"
        has_ew = fmt.endswith("1")
        has_vw = len(fmt) >= 2 and fmt[-2] == "1"
        for _ in range(n):
            tok = next(body).split()
            cnt = len(tok) - (1 if has_vw else 0)
            degs.append(cnt // 2 if has_ew else cnt)
    degs = np.asarray(degs, dtype=np.uint64)
    e = int(degs.sum())
    base = (3 + n + 1) * _W
    offsets = base + np.concatenate([[0], np.cumsum(degs)]).astype(np.uint64) * _W
    # pass 2: stream targets
    with open(out_path, "wb") as out, open(metis_path) as f:
        out.write(np.array([_VERSION, n, e], dtype=np.uint64).tobytes())
        out.write(offsets.astype(np.uint64).tobytes())
        body = _metis_lines(f)
        next(body)  # header
        for _ in range(n):
            tok = [int(t) for t in next(body).split()]
            if has_vw:
                tok = tok[1:]
            tgts = tok[0::2] if has_ew else tok
            out.write((np.asarray(tgts, dtype=np.uint64) - 1).tobytes())


def write_partition_binary(part: np.ndarray, path: str) -> None:
    part = np.asarray(part, dtype=np.uint64)
    with open(path, "wb") as f:
        f.write(np.array([len(part)], dtype=np.uint64).tobytes())
        f.write(part.tobytes())


def read_partition_binary(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(_W), dtype=np.uint64)[0])
        return np.frombuffer(f.read(n * _W), dtype=np.uint64).astype(np.int64)
