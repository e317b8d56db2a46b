"""Running an entry point under an op trace (the port's counterpart of
``repro/analysis/tracing.py``).

The reference traces each entry to a jaxpr and walks its equations.
The port has no traced program: `trace_entry` *runs* the entry once,
eagerly, on its canonical inputs, under two modes that watch what it
does:

  * a ``TorchDispatchMode`` records every aten op it dispatches (the op
    list), the dtypes those ops produce (float64 and complex128 are
    flagged, as the reference flags their avals), and the host syncs
    torch makes below the Python level: ``aten._local_scalar_dense`` (the
    op behind ``.item()``, ``int(t)``, ``bool(t)`` and indexing by a
    tensor) and copies from a device to the host;
  * a ``TorchFunctionMode`` records the Python calls that read a tensor
    back to the host — ``.item()``, ``.tolist()``, ``.cpu()``,
    ``int()``/``bool()``/``float()``/``__index__`` — on a tensor of any
    device, so a CPU run sees every read that is a sync on the card (on
    a CPU tensor ``.cpu()`` and ``.tolist()`` dispatch nothing), and
    ``.to("cpu")`` of a device tensor.  The dispatch level counts what
    happens inside such a call as part of it, so each read counts once.

Each sync is located at the innermost frame of the port outside this
package (``core/refine.py:_refine_scan_batch``, line kept apart) — the
key an entry's ``allow_syncs`` names.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import sys
from typing import Dict, List, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.join(_PKG, "analysis")

#: Tensor methods that read a value back to the host
HOST_READS = ("item", "tolist", "cpu", "__int__", "__bool__", "__float__",
              "__index__")
#: dtypes no engine op may produce (the engine is f32/int32)
WIDE_DTYPES = (torch.float64, torch.complex128)
_SCALAR = torch.ops.aten._local_scalar_dense.default
_COPIES = (torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default)


@dataclasses.dataclass(frozen=True)
class Site:
    """A source site of the port: its file (relative to the package), its
    function and line."""
    file: str
    func: str
    line: int

    @property
    def location(self) -> str:
        return f"{self.file}:{self.func}"


def caller_site() -> Site:
    """The innermost frame of the port outside this package."""
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PKG) and not path.startswith(_SELF):
            rel = os.path.relpath(path, _PKG).replace(os.sep, "/")
            return Site(rel, f.f_code.co_name, f.f_lineno)
        f = f.f_back
    return Site("<caller>", "", 0)


@dataclasses.dataclass(frozen=True)
class Sync:
    what: str           # "item", "cpu", "_local_scalar_dense", "d2h copy"
    site: Site


@dataclasses.dataclass
class TracedEntry:
    name: str
    ops: List[str]                  # aten overloads, in dispatch order
    syncs: List[Sync]
    wide: List[Tuple[str, str, Site]]   # (op, dtype, site)
    launches: Dict[str, float]      # launch counter deltas of the run

    def sync_sites(self) -> Dict[str, int]:
        """{location: host reads made there} over the run."""
        return dict(collections.Counter(s.site.location for s in self.syncs))


class _Reads(TorchFunctionMode):
    """Python-level host reads (module docstring)."""

    def __init__(self, trace: "OpTrace"):
        super().__init__()
        self.trace = trace

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        read = (args and isinstance(args[0], torch.Tensor)
                and (name in HOST_READS or (
                    name == "to" and args[0].device.type != "cpu"
                    and _to_host(args[1:], kwargs))))
        if not read:
            return func(*args, **kwargs)
        self.trace.syncs.append(Sync(name, caller_site()))
        self.trace.depth += 1
        try:
            return func(*args, **kwargs)
        finally:
            self.trace.depth -= 1


def _to_host(args, kwargs) -> bool:
    dev = kwargs.get("device")
    cands = [dev] if dev is not None else list(args[:1])
    for c in cands:
        if isinstance(c, (str, torch.device)) and \
                torch.device(c).type == "cpu":
            return True
    return False


class _Ops(TorchDispatchMode):
    """aten-level op list, wide dtypes and syncs (module docstring)."""

    def __init__(self, trace: "OpTrace"):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        t = self.trace
        t.ops.append(str(func))
        if t.depth == 0:
            if func is _SCALAR:
                t.syncs.append(Sync("_local_scalar_dense", caller_site()))
            elif func in _COPIES and _d2h(func, args, kwargs, out):
                t.syncs.append(Sync("d2h copy", caller_site()))
        for x in tree_leaves(out):
            if isinstance(x, torch.Tensor) and x.dtype in WIDE_DTYPES:
                t.wide.append((str(func), str(x.dtype).replace("torch.", ""),
                               caller_site()))
                break
        return out


def _d2h(func, args, kwargs, out) -> bool:
    src = args[1] if func is _COPIES[1] else args[0]
    dst = args[0] if func is _COPIES[1] else out
    return (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
            and src.device.type != "cpu" and dst.device.type == "cpu")


class OpTrace:
    """Context manager: ``with OpTrace() as t: fn(*args)`` fills ``t.ops``,
    ``t.syncs`` and ``t.wide``."""

    def __init__(self):
        self.ops: List[str] = []
        self.syncs: List[Sync] = []
        self.wide: List[Tuple[str, str, Site]] = []
        self.depth = 0
        self._modes = (_Reads(self), _Ops(self))

    def __enter__(self) -> "OpTrace":
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False


def launch_counts(names) -> Dict[str, float]:
    from repro_torch.obs import metrics
    return {n: metrics.get(n) for n in names}


def trace_entry(entry, device) -> TracedEntry:
    """Build one registry entry on ``device`` and run it once under an
    `OpTrace`, reading its kernels' launch counters around the run."""
    fn, args = entry.build(device)
    before = launch_counts(entry.kernels)
    with OpTrace() as t:
        fn(*args)
    after = launch_counts(entry.kernels)
    return TracedEntry(name=entry.name, ops=t.ops, syncs=t.syncs, wide=t.wide,
                       launches={n: after[n] - before[n] for n in before})
