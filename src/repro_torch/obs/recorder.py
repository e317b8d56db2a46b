"""Trace recorder: hierarchical spans, counters, gauges, explicit-track
events and quality trajectories.

A `Recorder` journals everything as flat event dicts (one JSON object per
line on export, Chrome-trace convertible via obs.trace), with the same
keys and ``ph`` letters as the JAX package's recorder, so a journal
written by either package reads in the other:

  * ``ph: "B"/"E"`` — span begin/end.  Timestamps are wall-anchored
    microseconds (``time.time()`` anchor + ``perf_counter`` deltas), so
    events from several recorders merge into one consistent timeline.
    Nesting is tracked per thread; every event carries the thread id.
  * ``ph: "C"`` — a counter increment (also applied to the global
    ``registry.metrics``).
  * ``ph: "G"`` — a gauge's last value (also set in ``registry.metrics``).
  * ``ph: "P"`` — a quality-trajectory point: objective / imbalance per
    level, V-cycle, generation or restart, also kept structured in
    ``Recorder.trajectories[series]`` so "never-worse" guarantees are
    inspectable curves.
  * ``ph: "I"`` — an instant; events of ``begin``/``end``/``instant``
    carry a ``track`` (a named row: a serve slot, the request queue).

The disabled path is `NULL` (a `NullRecorder` singleton): every method is
a no-op and ``span`` returns one shared reusable context manager, so hot
paths pay a function call, never an allocation, a trace or a device sync.
Engine code guards any extra objective evaluation behind
``recorder.enabled``.

While a torch profiler session records, every span of an enabled
recorder also opens a ``_RecordFunctionFast`` range of its name: a host
operation on the profiler's own clock, so the spans show by name in the
session beside the kernels they launch and name the host side of any
device idle gap inside them.  Unlike a ``record_function`` (a user
annotation, which the profiler copies onto the device's timeline) it is
never counted as device work.  The profiler's flag is read first: no
profiler call is made while no session records.

On a process where CUDA is initialised every span also records one pair
of CUDA timing events on the current stream, at enter and at exit, with
no synchronise.  A span's device time is the card's interval from the
work enqueued after its start to the last work enqueued before its end,
on that stream.  ``span_times()`` resolves the pairs (it synchronises
their end events, so call it after the work) and returns per span name
the calls, host seconds and device seconds; resolved ``"E"`` events then
carry ``device_us``.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

from repro_torch.obs.registry import metrics

#: resolve the spans whose device work is done once this many await it,
#: so a long-lived recorder holds a bounded number of CUDA events
_DRAIN_AT = 1024


def _timing_event():
    """A CUDA timing event recorded now on the current stream, or None on
    a process where CUDA is not initialised."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _NullSpan:
    """Reusable no-op context manager (one instance for the process)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """The disabled recorder: every operation is a no-op."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def count(self, name: str, value: float = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def point(self, series: str, **values) -> None:
        pass

    def begin(self, name: str, track=None, **attrs) -> None:
        pass

    def end(self, name: str, track=None) -> None:
        pass

    def instant(self, name: str, track=None, **attrs) -> None:
        pass


#: The shared disabled recorder (also the default ambient recorder).
NULL = NullRecorder()


class _Span:
    __slots__ = ("rec", "name", "attrs", "_range", "_t0", "_ev0")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self.rec = rec
        self.name = name
        self.attrs = attrs
        self._range = None

    def __enter__(self):
        rec = self.rec
        if _profiler._is_profiler_enabled:
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        depth = rec._push(self.name)
        self._t0 = time.perf_counter()
        ev = {"ph": "B", "name": self.name, "ts": rec._now_us(),
              "tid": threading.get_ident(), "depth": depth}
        if self.attrs:
            ev["args"] = self.attrs
        rec._emit(ev)
        self._ev0 = _timing_event()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        ev1 = None if self._ev0 is None else _timing_event()
        host_s = time.perf_counter() - self._t0
        depth = rec._pop()
        end = {"ph": "E", "name": self.name, "ts": rec._now_us(),
               "tid": threading.get_ident(), "depth": depth}
        rec._emit(end)
        rec._timed(self.name, host_s, self._ev0, ev1, end)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Recorder:
    """An enabled observability context for one run (or one bench cell).

    Counters written through ``count`` land in the global registry too;
    ``counters()`` returns this run's deltas, including the kernels'
    ``kernels/builds`` and ``kernels/<name>/launches``, so
    ``compile_count`` is the number of ``nvcc`` kernel builds made during
    this recorder's lifetime.  ``compile_counters`` keeps the JAX
    package's signature: the build counter is always on (the build
    increments it), so there is nothing to install.  Spans are timed on
    the host and, where CUDA is initialised, on the card (module
    docstring; `span_times`).
    """

    enabled = True

    def __init__(self, name: str = "run", compile_counters: bool = True):
        self.name = name
        self._lock = threading.RLock()
        self.events: List[Dict[str, Any]] = []
        self.trajectories: Dict[str, List[Dict[str, Any]]] = {}
        self._local = threading.local()
        self._t0 = time.perf_counter()
        self._ts0_us = time.time() * 1e6
        self._snap0 = metrics.snapshot()
        # per span name [calls, host s, device s or None]; device pairs
        # (name, start event, end event, "E" event) not yet resolved
        self._times: Dict[str, list] = {}
        self._pending: List[tuple] = []

    # -- internals ----------------------------------------------------------
    def _now_us(self) -> float:
        return self._ts0_us + (time.perf_counter() - self._t0) * 1e6

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, name: str) -> int:
        st = self._stack()
        st.append(name)
        return len(st) - 1

    def _pop(self) -> int:
        st = self._stack()
        if st:
            st.pop()
        return len(st)

    def _emit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self.events.append(ev)

    def _timed(self, name: str, host_s: float, ev0, ev1, end: dict) -> None:
        with self._lock:
            t = self._times.setdefault(name, [0, 0.0, None])
            t[0] += 1
            t[1] += host_s
            if ev0 is not None:
                self._pending.append((name, ev0, ev1, end))
                if len(self._pending) >= _DRAIN_AT:
                    self._resolve(wait=False)

    def _resolve(self, wait: bool = True) -> None:
        """Turn the pending event pairs into device seconds, in the order
        they closed: all of them (``wait``: synchronising each end event),
        or those whose end event the card has reached."""
        with self._lock:
            done = 0
            for name, ev0, ev1, end in self._pending:
                if wait:
                    ev1.synchronize()
                elif not ev1.query():
                    break
                us = 1e3 * ev0.elapsed_time(ev1)
                end["device_us"] = us
                t = self._times[name]
                t[2] = (t[2] or 0.0) + us / 1e6
                done += 1
            del self._pending[:done]

    # -- public API ---------------------------------------------------------
    def span(self, name: str, **attrs) -> _Span:
        """Hierarchical trace span: ``with rec.span("coarsen", level=3):``"""
        return _Span(self, name, attrs)

    def span_times(self) -> Dict[str, Dict[str, Any]]:
        """Per span name: ``calls``, ``host_s`` (host seconds) and
        ``device_s`` (device seconds of the calls that recorded CUDA events;
        None where none did).  Synchronises the recorded events: call it
        after the work."""
        self._resolve()
        with self._lock:
            return {name: {"calls": c, "host_s": h, "device_s": d}
                    for name, (c, h, d) in self._times.items()}

    def span_path(self) -> str:
        """Slash-joined names of the open spans on this thread."""
        return "/".join(self._stack())

    def count(self, name: str, value: float = 1) -> None:
        metrics.inc(name, value)
        self._emit({"ph": "C", "name": name, "ts": self._now_us(),
                    "tid": threading.get_ident(), "value": value})

    def gauge(self, name: str, value: float) -> None:
        metrics.set_gauge(name, value)
        self._emit({"ph": "G", "name": name, "ts": self._now_us(),
                    "tid": threading.get_ident(), "value": value})

    def point(self, series: str, **values) -> None:
        """Append a quality-trajectory point (objective, imbalance, …)."""
        row = dict(values)
        with self._lock:
            self.trajectories.setdefault(series, []).append(row)
        self._emit({"ph": "P", "name": series, "ts": self._now_us(),
                    "tid": threading.get_ident(), "values": row})

    # -- explicit-track events (serve tracing, DESIGN.md §13) ---------------
    # Unlike ``span``, these do not ride the per-thread nesting stack: the
    # caller owns the track (a named Chrome/Perfetto row, e.g. one per serve
    # slot) and guarantees B/E matching.  A request's lifetime can then span
    # many host calls (enqueue → slot-assign → decode ticks → finish)
    # without ever holding a Python context manager open.

    def begin(self, name: str, track=None, **attrs) -> None:
        """Open an event on an explicitly named track."""
        ev = {"ph": "B", "name": name, "ts": self._now_us(),
              "tid": threading.get_ident()}
        if track is not None:
            ev["track"] = str(track)
        if attrs:
            ev["args"] = attrs
        self._emit(ev)

    def end(self, name: str, track=None) -> None:
        """Close the matching ``begin`` on the same track."""
        ev = {"ph": "E", "name": name, "ts": self._now_us(),
              "tid": threading.get_ident()}
        if track is not None:
            ev["track"] = str(track)
        self._emit(ev)

    def instant(self, name: str, track=None, **attrs) -> None:
        """A zero-duration marker (Chrome "i" instant event)."""
        ev = {"ph": "I", "name": name, "ts": self._now_us(),
              "tid": threading.get_ident()}
        if track is not None:
            ev["track"] = str(track)
        if attrs:
            ev["args"] = attrs
        self._emit(ev)

    def counters(self) -> Dict[str, float]:
        """Counter deltas since this recorder was created."""
        base = self._snap0
        return {k: v - base.get(k, 0) for k, v in metrics.snapshot().items()
                if v != base.get(k, 0)}

    @property
    def compile_count(self) -> int:
        """``nvcc`` kernel builds during this recorder's lifetime (the
        delta of ``kernels/builds``; a library already built on disk is
        loaded, not counted)."""
        return int(self.counters().get("kernels/builds", 0))

    def trajectory(self, series: str, key: str = "objective") -> List[float]:
        """One trajectory series flattened to a list of ``key`` values."""
        return [p[key] for p in self.trajectories.get(series, ())
                if key in p]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            n_spans = sum(1 for e in self.events if e["ph"] == "B")
        return {"name": self.name, "spans": n_spans,
                "compile_count": self.compile_count,
                "counters": self.counters(),
                "trajectories": {k: len(v)
                                 for k, v in self.trajectories.items()}}
