"""Journal / trace export: JSONL round-trip and Chrome trace events.

The JSONL journal is the durable form: one ``{"kind": "recorder", ...}``
header line per recorder followed by its events (each stamped with the
recorder name), append-merged across recorders.  ``chrome_trace`` turns
the same events into the Chrome trace-event JSON that Perfetto
(https://ui.perfetto.dev) opens directly: spans as matched B/E duration
events, counters / gauges / trajectory points as "C" counter tracks,
explicit-track events (serve slots, the request queue) as named threads
via "M" thread_name metadata, and instants as "i" events.  The journal's
lines are the JAX package's: either package reads the other's.  Both
resolve a recorder's device-timed spans first (`Recorder.span_times`), so
a span's "E" event carries its device time: ``device_us`` in the journal,
``args.device_us`` in the Chrome trace.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Tuple, Union

from repro_torch.obs.recorder import Recorder
from repro_torch.obs.registry import metrics

Recorders = Union[Recorder, Iterable[Recorder]]

#: tid block where named tracks live — far above any real thread index the
#: remapper below assigns, so the two can never collide.
_TRACK_TID0 = 1_000_000


def _as_list(recs: Recorders) -> List[Recorder]:
    return [recs] if isinstance(recs, Recorder) else list(recs)


def write_jsonl(recs: Recorders, path: str) -> int:
    """Write the event journal(s) as JSON lines; returns lines written."""
    lines = 0
    with open(path, "w") as f:
        for rec in _as_list(recs):
            hdr = {"kind": "recorder", "name": rec.name,
                   "counters": rec.counters(),
                   "trajectories": rec.trajectories}
            f.write(json.dumps(hdr) + "\n")
            lines += 1
            rec._resolve()
            with rec._lock:
                events = list(rec.events)
            for ev in events:
                f.write(json.dumps({"rec": rec.name, **ev}) + "\n")
                lines += 1
    return lines


def read_jsonl(path: str) -> Tuple[List[Dict[str, Any]],
                                   List[Dict[str, Any]]]:
    """Read a journal back → (recorder header dicts, event dicts).

    Crash-safe: a truncated trailing line (the partial write an interrupted
    run leaves behind) is dropped and the valid prefix returned.  Corrupt
    lines *before* the end of the file still raise — that is data loss, not
    an interrupted append.
    """
    headers, events = [], []
    with open(path) as f:
        lines = f.readlines()
    last = len(lines) - 1
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            if i == last:
                break               # interrupted final append: keep prefix
            raise
        (headers if obj.get("kind") == "recorder" else events).append(obj)
    return headers, events


def chrome_trace(recs: Recorders,
                 registry_gauges: bool = False) -> Dict[str, Any]:
    """Chrome trace-event JSON (the ``traceEvents`` array format).

    Spans become matched B/E duration events on (pid, tid) tracks; counter
    increments, gauges and trajectory points become "C" counter events;
    instants become "i" events.  Events carrying a ``track`` name (the
    serve path's per-slot request timelines) are mapped onto dedicated
    tids with "M" thread_name metadata, so Perfetto shows them as named
    rows ("slot 0", "queue", …).  ``registry_gauges=True`` additionally
    snapshots the process-wide ``obs.metrics`` gauges as one final counter
    sample per gauge — quality/queue-depth curves land next to the spans.
    """
    pid = os.getpid()
    tes: List[Dict[str, Any]] = []
    tracks: Dict[str, int] = {}
    last_ts = 0.0

    def _tid(ev) -> int:
        track = ev.get("track")
        if track is None:
            return ev.get("tid", 0)
        if track not in tracks:
            tid = _TRACK_TID0 + len(tracks)
            tracks[track] = tid
            tes.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": track}})
        return tracks[track]

    for rec in _as_list(recs):
        rec._resolve()
        with rec._lock:
            events = list(rec.events)
        totals: Dict[str, float] = {}
        for ev in events:
            last_ts = max(last_ts, ev.get("ts", 0.0))
            if ev["ph"] in ("B", "E"):
                out = {"name": ev["name"], "ph": ev["ph"], "ts": ev["ts"],
                       "pid": pid, "tid": _tid(ev), "cat": rec.name}
                if "args" in ev:
                    out["args"] = ev["args"]
                if "device_us" in ev:
                    out["args"] = {"device_us": ev["device_us"]}
                tes.append(out)
            elif ev["ph"] == "I":
                out = {"name": ev["name"], "ph": "i", "ts": ev["ts"],
                       "pid": pid, "tid": _tid(ev), "cat": rec.name,
                       "s": "t"}
                if "args" in ev:
                    out["args"] = ev["args"]
                tes.append(out)
            elif ev["ph"] == "C":
                totals[ev["name"]] = totals.get(ev["name"], 0) + ev["value"]
                tes.append({"name": ev["name"], "ph": "C", "ts": ev["ts"],
                            "pid": pid, "tid": 0, "cat": rec.name,
                            "args": {"value": totals[ev["name"]]}})
            elif ev["ph"] == "G":
                tes.append({"name": ev["name"], "ph": "C", "ts": ev["ts"],
                            "pid": pid, "tid": 0, "cat": rec.name,
                            "args": {"value": ev["value"]}})
            elif ev["ph"] == "P":
                vals = {k: v for k, v in ev["values"].items()
                        if isinstance(v, (int, float))}
                if vals:
                    tes.append({"name": ev["name"], "ph": "C",
                                "ts": ev["ts"], "pid": pid, "tid": 0,
                                "cat": rec.name, "args": vals})
    if registry_gauges:
        for name, value in sorted(metrics.gauges().items()):
            tes.append({"name": name, "ph": "C", "ts": last_ts,
                        "pid": pid, "tid": 0, "cat": "registry",
                        "args": {"value": value}})
    return {"traceEvents": tes, "displayTimeUnit": "ms"}


def write_chrome_trace(recs: Recorders, path: str,
                       registry_gauges: bool = False) -> int:
    """Write the Chrome trace JSON; returns the number of trace events."""
    trace = chrome_trace(recs, registry_gauges=registry_gauges)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])
