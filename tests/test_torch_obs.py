"""`repro_torch.obs`'s recorder, registry and trace export held against
the JAX package's `repro.obs`: the same calls give the same events and
the same Chrome trace (apart from timestamps), a journal written by one
package reads in the other, a torn last line is dropped, the disabled
recorder keeps nothing, ``compile_count`` counts ``nvcc`` builds, and a
recorder's spans appear in a torch.profiler trace."""
import json
import subprocess
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as robs

from repro_torch import obs as tobs
from repro_torch.core import interface as tif
from repro_torch.io.generators import grid2d
from repro_torch.kernels import build as B


def _script(obs):
    """One recorder driven through every kind of event, nested spans and
    explicit tracks included; returns it and the span paths it saw."""
    rec = obs.Recorder("script", compile_counters=False)
    paths = []
    with rec.span("outer", level=0):
        paths.append(rec.span_path())
        with rec.span("inner", level=1, n=12):
            paths.append(rec.span_path())
            rec.count("t/hits", 2)
            rec.count("t/hits")
            rec.gauge("t/depth", 3.5)
        rec.point("quality", cycle=0, objective=10.0, accepted=True)
        rec.point("quality", cycle=1, objective=9.0, note="x")
    paths.append(rec.span_path())
    rec.begin("req 4", track="slot 1", rid=4, prompt_len=7)
    rec.instant("tok", track="slot 1", rid=4, token=11)
    rec.instant("enqueue", track="queue", rid=5)
    rec.begin("prefill", track=2)
    rec.end("prefill", track=2)
    rec.end("req 4", track="slot 1")
    rec.instant("mark")
    rec.gauge("t/depth", 1.0)
    return rec, paths


def _untimed(events):
    return [{k: v for k, v in ev.items() if k not in ("ts", "tid")}
            for ev in events]


def test_recorder_events_match_reference():
    got, got_paths = _script(tobs)
    want, want_paths = _script(robs)
    assert got_paths == want_paths == ["outer", "outer/inner", ""]
    assert _untimed(got.events) == _untimed(want.events)
    assert got.trajectories == want.trajectories
    assert got.trajectory("quality") == want.trajectory("quality") == [
        10.0, 9.0]
    assert got.counters() == want.counters() == {"t/hits": 3}
    assert got.summary() == want.summary()
    assert tobs.metrics.gauge("t/depth") == 1.0


def test_chrome_trace_matches_reference():
    got, want = _script(tobs)[0], _script(robs)[0]

    def untimed(trace):
        return [{k: v for k, v in ev.items() if k != "ts"}
                for ev in trace["traceEvents"]]

    tr = tobs.chrome_trace(got)
    assert untimed(tr) == untimed(robs.chrome_trace(want))
    assert tr["displayTimeUnit"] == "ms"
    tids = {ev["args"]["name"]: ev["tid"] for ev in tr["traceEvents"]
            if ev["ph"] == "M"}
    assert tids == {"slot 1": 1_000_000, "queue": 1_000_001,
                    "2": 1_000_002}
    # counters are cumulative, gauges and points are counter samples
    cs = [(ev["name"], ev["args"]) for ev in tr["traceEvents"]
          if ev["ph"] == "C"]
    assert ("t/hits", {"value": 2}) in cs and ("t/hits", {"value": 3}) in cs
    assert ("quality", {"cycle": 0, "objective": 10.0, "accepted": True}) \
        in cs
    # the registry's gauges ride along only when asked for, last
    with_gauges = tobs.chrome_trace([got], registry_gauges=True)
    extra = with_gauges["traceEvents"][len(tr["traceEvents"]):]
    assert extra and {ev["cat"] for ev in extra} == {"registry"}
    assert {"name": "t/depth", "ph": "C", "tid": 0, "cat": "registry",
            "args": {"value": 1.0}} in [
        {k: v for k, v in ev.items() if k not in ("ts", "pid")}
        for ev in extra]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_reads_in_the_other_package(tmp_path, writer):
    obs, other = (tobs, robs) if writer == "port" else (robs, tobs)
    rec = _script(obs)[0]
    second = obs.Recorder("second", compile_counters=False)
    with second.span("alone"):
        second.count("t/other", 5)
    path = str(tmp_path / "journal.jsonl")
    n = obs.write_jsonl([rec, second], path)
    assert n == 2 + len(rec.events) + len(second.events)
    headers, events = other.read_jsonl(path)
    assert (headers, events) == obs.read_jsonl(path)
    assert [h["name"] for h in headers] == ["script", "second"]
    # a recorder's counters are the registry's deltas since it was made
    assert headers[0]["counters"] == {"t/hits": 3, "t/other": 5}
    assert headers[1]["counters"] == {"t/other": 5}
    assert [{k: v for k, v in ev.items() if k != "rec"} for ev in events] \
        == json.loads(json.dumps(rec.events + second.events))


def test_read_jsonl_tolerates_truncated_tail(tmp_path):
    rec = _script(tobs)[0]
    p = str(tmp_path / "j.jsonl")
    tobs.write_jsonl(rec, p)
    whole = tobs.read_jsonl(p)
    raw = Path(p).read_bytes()
    Path(p).write_bytes(raw[:-7])          # a writer killed mid-line
    headers, events = tobs.read_jsonl(p)
    assert headers == whole[0] and events == whole[1][:-1]
    assert robs.read_jsonl(p) == (headers, events)
    lines = raw.decode().strip().split("\n")
    lines[1] = lines[1][:-5]               # damage before the end raises
    Path(p).write_text("\n".join(lines) + "\n")
    with pytest.raises(json.JSONDecodeError):
        tobs.read_jsonl(p)


def test_null_recorder_keeps_nothing():
    null = tobs.NULL
    assert tobs.current() is null and not null.enabled
    assert not hasattr(null, "__dict__")
    assert null.span("a", big=list(range(10))) is null.span("b")

    def every_hook():
        with null.span("s"):
            null.count("x")
            null.gauge("g", 2.0)
            null.point("q")
            null.begin("r", track="slot 0")
            null.instant("tok", track="slot 0")
            null.end("r", track="slot 0")

    every_hook()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(5000):
            every_hook()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, "filename")
                if d.traceback[0].filename.endswith("recorder.py"))
    assert grown <= 0


def test_registry_gauges_match_reference():
    got, want = tobs.CounterRegistry(), robs.CounterRegistry()
    for reg in (got, want):
        reg.inc("a", 2)
        reg.set_gauge("g", 1.5)
        reg.set_gauge("h", 2)
        reg.set_gauge("g", 0.5)
        reg.reset("h")
    for name in ("g", "h", "missing"):
        assert got.gauge(name) == want.gauge(name)
        assert got.gauge(name, -1) == want.gauge(name, -1)
    assert got.gauges() == want.gauges() == {"g": 0.5}
    assert got.snapshot() == want.snapshot() == {"a": 2}
    got.reset()
    assert got.gauges() == {} and got.snapshot() == {}


def test_compile_count_counts_nvcc_builds(tmp_path, monkeypatch):
    """A build that runs the compiler counts once; loading a library that
    is already on disk does not."""
    def fake_run(cmd, capture_output, text):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(B, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(B.subprocess, "run", fake_run)
    src = tmp_path / "k.cu"
    src.write_text("// kernel")
    rec = tobs.Recorder("builds")
    lib = B.build(src, tmp_path / "out", B.NVCC_FLAGS)
    assert B.build(src, tmp_path / "out", B.NVCC_FLAGS) == lib
    assert rec.compile_count == 1
    assert rec.summary()["compile_count"] == 1
    assert tobs.Recorder("later").compile_count == 0


def _span_balance(trace):
    depth = {}
    for ev in trace["traceEvents"]:
        if ev["ph"] in ("B", "E"):
            key = ev["tid"]
            depth[key] = depth.get(key, 0) + (1 if ev["ph"] == "B" else -1)
            assert depth[key] >= 0
    return depth


def test_recorded_kaffpa_equals_unrecorded_and_reaches_the_profiler():
    g = grid2d(16, 16)
    args = (g.n, None, g.xadj, None, g.adjncy, 2, 0.03)
    cut0, part0 = tif.kaffpa(*args, seed=2, mode=tif.FAST, device="cpu")
    rec = tobs.Recorder("kaffpa")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cut1, part1 = tif.kaffpa(*args, seed=2, mode=tif.FAST, report=rec,
                                 device="cpu")
    assert cut1 == cut0 and np.array_equal(part0, part1)
    spans = {e["name"] for e in rec.events if e["ph"] == "B"}
    assert {"run", "multilevel", "hierarchy", "coarsen", "uncoarsen",
            "refine"} <= spans
    assert rec.trajectory("cycles")
    assert {"multilevel", "refine", "hierarchy"} <= {
        e.name for e in prof.events()}
    assert set(_span_balance(tobs.chrome_trace(rec)).values()) == {0}
