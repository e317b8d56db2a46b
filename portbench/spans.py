"""The port's own layer spans, as the per-layer readers of a traced run
read them: the device seconds that the recorder of the run's profiler
session (``repro_torch.obs.profiled()``) holds for one span name, per
traced iteration, in milliseconds.  The spans' device times are the
port's CUDA timing events, recorded at each span's enter and exit on the
current stream.  Nothing to read (None) in a run of another loop, where
the port never ran (the control), where it has no such recorder (an older
port) or where the span was not recorded."""
from __future__ import annotations

import sys


def device_ms(r, loop: str, span: str):
    """Milliseconds of device time of ``span`` per traced iteration of the
    reading ``r`` of a ``loop`` cell, or None."""
    if r.loop != loop or not r.iters:
        return None
    obs = sys.modules.get("repro_torch.obs")     # loaded by the port alone
    profiled = getattr(obs, "profiled", None)
    rec = profiled() if profiled else None
    if rec is None:
        return None
    t = rec.span_times().get(span)
    if t is None or not t["device_s"]:
        return None
    return 1e3 * t["device_s"] / r.iters
