"""Trace recorder: hierarchical spans, counters, quality trajectories.

A `Recorder` journals everything as flat event dicts:

  * ``ph: "B"/"E"`` — span begin/end.  Timestamps are wall-anchored
    microseconds (``time.time()`` anchor + ``perf_counter`` deltas).
    Nesting is tracked per thread; every event carries the thread id.
  * ``ph: "C"`` — a counter increment (also applied to the global
    ``registry.metrics``).
  * ``ph: "P"`` — a quality-trajectory point: objective / imbalance per
    level, V-cycle or restart, also kept structured in
    ``Recorder.trajectories[series]``.

The disabled path is `NULL` (a `NullRecorder` singleton): every method is
a no-op and ``span`` returns one shared reusable context manager, so hot
paths pay a function call, never an allocation or a device sync.  Engine
code guards any extra objective evaluation behind ``recorder.enabled``.
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

    def point(self, series: str, **values) -> None:
        pass


#: The shared disabled recorder (also the default ambient recorder).
NULL = NullRecorder()


class _Span:
    __slots__ = ("rec", "name", "attrs")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self.rec = rec
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        rec = self.rec
        depth = rec._push(self.name)
        ev = {"ph": "B", "name": self.name, "ts": rec._now_us(),
              "tid": threading.get_ident(), "depth": depth}
        if self.attrs:
            ev["args"] = self.attrs
        rec._emit(ev)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        depth = rec._pop()
        rec._emit({"ph": "E", "name": self.name, "ts": rec._now_us(),
                   "tid": threading.get_ident(), "depth": depth})
        return False


class Recorder:
    """An enabled observability context for one run.

    Counters written through ``count`` land in the global registry too;
    ``counters()`` returns this run's deltas, including the kernel build
    and launch counters.
    """

    enabled = True

    def __init__(self, name: str = "run"):
        self.name = name
        self._lock = threading.RLock()
        self.events: List[Dict[str, Any]] = []
        self.trajectories: Dict[str, List[Dict[str, Any]]] = {}
        self._local = threading.local()
        self._t0 = time.perf_counter()
        self._ts0_us = time.time() * 1e6
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

    def count(self, name: str, value: float = 1) -> None:
        metrics.inc(name, value)
        self._emit({"ph": "C", "name": name, "ts": self._now_us(),
                    "tid": threading.get_ident(), "value": value})

    def point(self, series: str, **values) -> None:
        """Append a quality-trajectory point (objective, imbalance, …)."""
        row = dict(values)
        with self._lock:
            self.trajectories.setdefault(series, []).append(row)
        self._emit({"ph": "P", "name": series, "ts": self._now_us(),
                    "tid": threading.get_ident(), "values": row})

    def counters(self) -> Dict[str, float]:
        """Counter deltas since this recorder was created."""
        base = self._snap0
        return {k: v - base.get(k, 0) for k, v in metrics.snapshot().items()
                if v != base.get(k, 0)}

    def trajectory(self, series: str, key: str = "objective") -> List[float]:
        """One trajectory series flattened to a list of ``key`` values."""
        return [p[key] for p in self.trajectories.get(series, ())
                if key in p]
