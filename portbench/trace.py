"""The device trace of a traced run: torch.profiler over a stretch of the
window, reduced to what the per-layer readers and the breakdown need.

The reduction copies ``tools/profile_torch_train.py``'s ``device_profile``
and ``kind``: device busy time is the union of every device activity's
interval, and a matrix product is a kernel whose name holds gemm, cutlass
or xmma.  A host range that the profiler mirrors on the device as an
annotation (``nccl:all_reduce`` beside NCCL's own kernel) is no activity.
The stretch is marked on the host by a ``record_function`` span
(`WINDOW`) that ends after a device synchronise, so the span holds all of
its device work.
"""
from __future__ import annotations

import numpy as np

WINDOW = "portbench.window"
MATMUL = ("gemm", "cutlass", "xmma")
#: the benchmark's own spans: on the host they wrap everything, and the
#: profiler mirrors them on the device as annotations, not operations
OWN = "portbench."


def is_matmul(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in MATMUL)


class Profiler:
    """``start()`` and ``stop()`` around the traced iterations, which run
    inside ``with span():``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def start(self):
        self.prof.__enter__()

    def span(self):
        import torch
        return torch.profiler.record_function(WINDOW)

    def stop(self) -> dict:
        self.prof.__exit__(None, None, None)
        return summarize(self.prof.events())


def summarize(events) -> dict:
    """{"window_s", "busy_s", "device_s_by_name", "idle_s_by_host_op"} of
    the events inside the `WINDOW` span; an empty dict if there is none."""
    from torch.autograd import DeviceType
    win = [e for e in events if e.name == WINDOW]
    if not win:
        return {}
    w0 = min(e.time_range.start for e in win)
    w1 = max(e.time_range.end for e in win)
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if t <= w0 or s >= w1:
            continue
        if e.name.startswith(OWN):
            continue
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((max(s, w0), min(t, w1), e.name))
        else:
            host.append((s, t, e.name))
    by_name: dict = {}
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
    dev.sort()
    busy, gaps, cur_s, cur_e = 0.0, [], None, w0
    for s, t, _ in dev:
        if cur_s is None or s > cur_e:
            if s > cur_e:
                gaps.append((cur_e, s))
            if cur_s is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_s is not None:
        busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "device_s_by_name": by_name,
            "idle_s_by_host_op": name_gaps(gaps, host)}


def name_gaps(gaps: list, host: list, longest: int = 256) -> dict:
    """Seconds of the ``longest`` idle gaps, summed by the innermost host
    op that was running when each began ("host idle" where none was): a
    runtime call such as cudaDeviceSynchronize means the host was waiting
    on the device, an operator that it was still dispatching."""
    out: dict = {}
    if not gaps:
        return out
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    for g0, g1 in gaps:
        name = "host idle"
        if len(host):
            live = np.nonzero((starts <= g0) & (ends > g0))[0]
            if len(live):
                name = host[live[np.argmax(starts[live])]][2]
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e6
    return out


def top(by_name: dict, n: int = 10) -> list:
    return [[k[:160], v] for k, v in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]
