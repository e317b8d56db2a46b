"""The engine-wide counter registry.

One thread-safe registry is the single source of truth for every counter
the engine emits: view builds (``engine/view_builds``), levels, V-cycles,
refinement moves, and the kernels' own counters — ``kernels/builds`` for
each kernel library compiled and ``kernels/<name>/launches`` for each
kernel launch.  A `Recorder` snapshots the registry at construction, so
``Recorder.counters()`` gives per-run deltas.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional


class CounterRegistry:
    """Thread-safe monotonically increasing counters, keyed by
    slash-separated names (``"engine/view_builds"``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1) -> float:
        with self._lock:
            new = self._counters.get(name, 0) + value
            self._counters[name] = new
            return new

    def get(self, name: str, default: float = 0) -> float:
        with self._lock:
            return self._counters.get(name, default)

    def reset(self, name: Optional[str] = None) -> None:
        """Reset one counter, or the whole registry with ``None``."""
        with self._lock:
            if name is None:
                self._counters.clear()
            else:
                self._counters.pop(name, None)

    def snapshot(self) -> Dict[str, float]:
        """Copy of the counter map (the per-run delta anchor)."""
        with self._lock:
            return dict(self._counters)


#: The process-wide registry every engine counter lands in.
metrics = CounterRegistry()
