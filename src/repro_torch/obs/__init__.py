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
the ``nvcc`` kernel builds of the recorder's lifetime.

The model and training paths have layer spans (``model/forward``,
``model/mamba_layer``, ``model/shared_block``, ``model/dense_block``,
``model/rwkv_block``, ``model/encoder_block``, ``model/head``,
``train/step``, ``train/forward``, ``train/backward``,
``train/adamw_update``, ``train/clip``).  An operator gets them in one of
two ways:

    with obs.use(rec):                      # an installed recorder
        logits, _ = transformer.forward(model, cfg, tokens)
    rec.span_times()["model/head"]          # calls, host_s, device_s

    with torch.profiler.profile(...) as prof:   # or a profiler session
        logits, _ = transformer.forward(model, cfg, tokens)
    obs.profiled().span_times()             # that session's spans

A span's device time is the card's interval, on the current stream, from
the work enqueued after the span opened to the last work enqueued before
it closed (CUDA timing events, resolved when read; see `recorder`).
While a profiler records, each span is also a host range of the same name
in the profiler's trace, never counted as device work.

With no recorder installed and no profiler recording the ambient recorder
is `NULL`: every hook is a no-op.  While a torch profiler records and no
recorder is installed, it is the session's own recorder (`profiled`), as
profiling turns ``record_function`` on.
"""
from __future__ import annotations

import contextlib
import threading

from torch.autograd import profiler as _profiler

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
    "current", "use", "profiled", "NULL_TELEMETRY", "EwmaRate",
    "QuantileSketch", "ServeTelemetry", "TrafficAccumulator",
    "WindowedCounter",
]

_current = NULL
#: the recorder of the latest profiler session, and whether that session
#: may still be recording (cleared wherever the profiler's flag reads off)
_session = None
_session_live = False
_session_lock = threading.Lock()


def current():
    """The ambient recorder: the one a ``use`` context installed; with none,
    while a torch profiler records, the session's recorder (`profiled`);
    else `NULL`."""
    global _session_live
    if _current is not NULL:
        return _current
    if _profiler._is_profiler_enabled:
        return _session_recorder()
    _session_live = False
    return NULL


def _session_recorder():
    global _session, _session_live
    with _session_lock:
        if not _session_live:
            _session = Recorder("profiled")
            _session_live = True
        return _session


def profiled():
    """The recorder of the latest torch profiler session in which a span
    ran with no recorder installed, or None.  It holds only the spans
    recorded while that session recorded; the first span of a later
    session starts a new one."""
    global _session_live
    if not _profiler._is_profiler_enabled:
        _session_live = False
    return _session


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
