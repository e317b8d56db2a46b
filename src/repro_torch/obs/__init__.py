"""repro_torch.obs — zero-dependency observability for the partitioning
engine and the serve path: hierarchical trace spans with a JSONL journal
and Chrome trace export, a thread-safe counter/gauge registry (with the
kernels' ``kernels/builds`` and ``kernels/<name>/launches`` counters),
per-level / per-cycle quality trajectories, and live serve telemetry
(latency sketches, throughput, the traffic hypergraph).

Everything is opt-in behind a recorder object:

    from repro_torch import obs

    rec = obs.Recorder("kaffpa")
    with obs.use(rec):
        part = kaffpa(g, 4, 0.03, "eco", seed=1)
    print(rec.counters()["kernels/lp_affinity/launches"],
          rec.compile_count, rec.trajectory("cycles"))
    obs.write_chrome_trace(rec, "trace.json")   # open in ui.perfetto.dev

or through the library interface's ``report=`` kwarg
(``interface.kaffpa(..., report=rec)``).  ``rec.compile_count`` counts
the ``nvcc`` kernel builds of the recorder's lifetime.  With no recorder
installed the ambient recorder is `NULL`: every hook is a no-op.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs.live import (NULL_TELEMETRY, EwmaRate, QuantileSketch,
                                  ServeTelemetry, TrafficAccumulator,
                                  WindowedCounter)
from repro_torch.obs.recorder import NULL, NullRecorder, Recorder
from repro_torch.obs.registry import CounterRegistry, metrics
from repro_torch.obs.trace import (chrome_trace, read_jsonl,
                                   write_chrome_trace, write_jsonl)

__all__ = [
    "NULL", "NullRecorder", "Recorder", "CounterRegistry", "metrics",
    "chrome_trace", "read_jsonl", "write_chrome_trace", "write_jsonl",
    "current", "use", "NULL_TELEMETRY", "EwmaRate", "QuantileSketch",
    "ServeTelemetry", "TrafficAccumulator", "WindowedCounter",
]

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
