"""Run one cell: set up, measure a window, check the answers, and make the
result line.

The traffic's ``loop`` (``loops/<loop>.py``) does the cell's work through
a `Context`: it draws the weights and the traffic from the seed, builds
the system under test, warms it up, hands `window` the call to time, and
after the window compares a sample of what that call produced with the
plain reference (``reference/``).  It returns its end-to-end values, its
readings (each number ``correct`` compares) and, in a traced run, the
trace's summary; this module turns them into the result's metrics, the
per-layer readings (``metrics/<name>.py``), ``checks`` and ``correct``.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

from portbench import spec as S
from portbench import trace as TR

PEAKS = S.HERE / "peaks.json"


@dataclasses.dataclass
class Context:
    cell: S.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    family: object
    scorer: object          # factory (cfg, traffic, w) → .forward(tokens)
    trainer: object         # factory (cfg, traffic, w) → .step(tokens), ...

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def memory_peak(self) -> int:
        import torch
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self):
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def window(ctx: Context, iterate, trace_iters: int = 0,
           min_iters: int = 0) -> dict:
    """Call ``iterate(i)`` for i = 0, 1, ... (each call ends in a device
    synchronise) until ``ctx.seconds`` have passed since the first began;
    the call under way at the deadline completes and ends the window.  It
    runs at least ``min_iters`` calls, and in a traced run iterations
    1 .. ``trace_iters`` run under the profiler (both beyond the deadline
    if the window is shorter)."""
    prof = TR.Profiler() if ctx.trace and trace_iters else None
    lat, summary, i = [], None, 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while True:
        traced = prof is not None and 1 <= i <= trace_iters
        if traced and i == 1:
            prof.start()
        ts = time.perf_counter()
        if traced:
            with prof.span():
                iterate(i)
        else:
            iterate(i)
        te = time.perf_counter()
        lat.append(te - ts)
        if traced and i == trace_iters:
            summary = prof.stop()
        i += 1
        if te >= deadline and i >= min_iters and (prof is None
                                                  or i > trace_iters):
            break
    return {"count": i, "window_s": te - t0, "latencies": lat,
            "trace": summary, "traced": trace_iters if prof else 0}


def factories(mode: str, family, device):
    """The scorer and trainer the loops time: the port's (``"program"``),
    or the control's, the plain reference at TF32 in the port's place
    (``"control"``)."""
    if mode == "program":
        from portbench import sut
        return sut.Scorer, sut.Trainer
    if mode != "control":
        raise ValueError(f"mode must be program or control, got {mode!r}")
    from portbench.reference import common, train

    class Scorer(train.Scorer):
        def forward(self, tokens):
            with common.precision("tf32", device):
                return super().forward(tokens)

    class Trainer(train.Trainer):
        def step(self, tokens):
            with common.precision("tf32", device):
                return super().step(tokens)

    return (lambda c, t, w: Scorer(family, c, t, w),
            lambda c, t, w: Trainer(family, c, t, w))


def peak_of(kind: str):
    table = S.load_json(PEAKS)
    return table.get(kind)


def run_cell(cell: S.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, mode: str = "program", make=None) -> dict:
    """The result line of one run of ``cell`` (module docstring).
    ``make`` replaces the (scorer, trainer) factories: tests plant faults
    with it."""
    import torch
    if cell.config["dtype"] != "float32":
        raise ValueError(f"{cell.name}: the benchmark runs float32 (TF32 "
                         f"off) only, not {cell.config['dtype']!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    family = S.family_module(cell.config)
    scorer, trainer = make or factories(mode, family, device)
    ctx = Context(cell, seed, seconds, trace, device, t_start, family,
                  scorer, trainer)
    out = S.loop_module(cell.traffic).run(ctx)
    checks = {name: {"value": value, "limit": cell.limits[name]}
              for name, value in out["readings"].items()}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if not trace:
        values = dict(out["end_to_end"], setup_s=out["setup_s"])
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        summary = out["trace"] or {}
        reading = Reading(cell.name, cell.config, cell.traffic, summary,
                          out["traced"], peak_of(dev["kind"]))
        result["metrics"] = {}
        for m in cell.per_layer:
            value = S.metric_module(m["name"]).read(reading)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        if summary:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
            result["breakdown"] = {
                "device_ops": TR.top(summary["device_s_by_name"]),
                "idle_gaps": TR.top(summary["idle_s_by_host_op"])}
    result["device"] = dev
    result["checks"] = checks
    return result


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the cell, the trace's summary of
    its ``iters`` traced iterations, and the card's peaks (None for a
    card the table does not list)."""
    cell: str
    config: dict
    traffic: dict
    trace: dict
    iters: int
    peak: dict | None

    @property
    def loop(self) -> str:
        return self.traffic["loop"]


def check_lines(result: dict) -> list:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in result["checks"].items()]
