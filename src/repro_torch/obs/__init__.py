"""repro_torch.obs — zero-dependency observability for the partitioning
engine: hierarchical trace spans, a thread-safe counter registry and
per-level / per-cycle quality trajectories.

Everything is opt-in behind a recorder object:

    from repro_torch import obs

    rec = obs.Recorder("kaffpa")
    with obs.use(rec):
        part = kaffpa(g, 4, 0.03, "eco", seed=1)
    print(rec.counters()["kernels/lp_affinity/launches"])

or through the library interface's ``report=`` kwarg
(``interface.kaffpa(..., report=rec)``).  With no recorder installed the
ambient recorder is `NULL`: every hook is a no-op.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs.recorder import NULL, NullRecorder, Recorder
from repro_torch.obs.registry import CounterRegistry, metrics

__all__ = ["NULL", "NullRecorder", "Recorder", "CounterRegistry", "metrics",
           "current", "use"]

_current = NULL


def current():
    """The ambient recorder (`NULL` unless a ``use`` context is active)."""
    return _current


@contextlib.contextmanager
def use(recorder):
    """Install ``recorder`` as the ambient recorder for the duration.

    ``use(None)`` is a passthrough (the current ambient recorder stays
    active) so entry points can thread an optional ``report=`` kwarg
    without clobbering an enclosing context.
    """
    global _current
    if recorder is None:
        yield _current
        return
    prev = _current
    _current = recorder
    try:
        yield recorder
    finally:
        _current = prev
