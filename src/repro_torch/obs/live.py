"""Serve-path telemetry (port of ``repro/obs/live.py``): so far only the
no-op default.  Streaming sketches, `ServeTelemetry` and the traffic
hypergraph wait for ROADMAP.md queue 1 item 11."""
from __future__ import annotations


class _NullTelemetry:
    """No-op telemetry (the default): the serve path pays one attribute
    access per hook, never a clock read or an allocation."""

    __slots__ = ()
    enabled = False
    traffic = None

    def enqueued(self, rid, queue_depth=0):
        pass

    def started(self, rid, slot, prompt_len, active=0):
        pass

    def prefilled(self, rid, slot, prompt_len=0):
        pass

    def step(self, new_tokens, active, queue_depth=0, step_s=None):
        pass

    def tick(self, rid, slot, token):
        pass

    def finished(self, rid, slot, n_out=0):
        pass

    def snapshot(self):
        return {}


NULL_TELEMETRY = _NullTelemetry()
