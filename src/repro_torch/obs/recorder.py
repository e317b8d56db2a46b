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

``annotate_xprof=True`` additionally wraps every span in a
``torch.profiler.record_function`` so engine spans show up by name in a
``torch.profiler`` session, beside the kernels they launch.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List

from repro_torch.obs.registry import metrics


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
    __slots__ = ("rec", "name", "attrs", "_ann")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self.rec = rec
        self.name = name
        self.attrs = attrs
        self._ann = None

    def __enter__(self):
        rec = self.rec
        depth = rec._push(self.name)
        ev = {"ph": "B", "name": self.name, "ts": rec._now_us(),
              "tid": threading.get_ident(), "depth": depth}
        if self.attrs:
            ev["args"] = self.attrs
        rec._emit(ev)
        if rec._xprof is not None:
            self._ann = rec._xprof(self.name)
            self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self._ann is not None:
            self._ann.__exit__(*exc)
        depth = rec._pop()
        rec._emit({"ph": "E", "name": self.name, "ts": rec._now_us(),
                   "tid": threading.get_ident(), "depth": depth})
        return False


class Recorder:
    """An enabled observability context for one run (or one bench cell).

    Counters written through ``count`` land in the global registry too;
    ``counters()`` returns this run's deltas, including the kernels'
    ``kernels/builds`` and ``kernels/<name>/launches``, so
    ``compile_count`` is the number of ``nvcc`` kernel builds made during
    this recorder's lifetime.  ``compile_counters`` keeps the JAX
    package's signature: the build counter is always on (the build
    increments it), so there is nothing to install.
    """

    enabled = True

    def __init__(self, name: str = "run", compile_counters: bool = True,
                 annotate_xprof: bool = False):
        self.name = name
        self._lock = threading.RLock()
        self.events: List[Dict[str, Any]] = []
        self.trajectories: Dict[str, List[Dict[str, Any]]] = {}
        self._local = threading.local()
        self._t0 = time.perf_counter()
        self._ts0_us = time.time() * 1e6
        self._xprof = None
        if annotate_xprof:
            from torch.profiler import record_function
            self._xprof = record_function
        self._snap0 = metrics.snapshot()

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

    # -- public API ---------------------------------------------------------
    def span(self, name: str, **attrs) -> _Span:
        """Hierarchical trace span: ``with rec.span("coarsen", level=3):``"""
        return _Span(self, name, attrs)

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
