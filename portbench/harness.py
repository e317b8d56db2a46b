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
import functools
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
    rank: int = 0           # of the ranks of a cell of several chips
    world: int = 1
    mesh: object = None     # the port's mesh of those ranks (sut.mesh)

    def weights(self, spec: list) -> dict:
        """The weights of ``spec`` drawn from the seed: whole for a cell of
        one chip; on a mesh the rank's blocks, drawn one group at a time;
        for the control of a cell of several chips, which runs in one
        process, drawn one group at a time as it reads them."""
        from portbench.reference import common
        if self.mesh is None and self.cell.chips > 1:
            return common.Streamed(spec, self.seed, self.device)
        if self.mesh is None:
            return common.draw(spec, self.seed, self.device)
        from portbench import sut
        return sut.rank_weights(self.cell.config, spec, self.seed,
                                self.device, self.mesh)

    def barrier(self):
        """Wait for every rank (nothing on one chip)."""
        if self.world > 1:
            import torch
            import torch.distributed as dist
            dist.all_reduce(torch.zeros(1, device=self.device))
            self.sync()

    def decide(self, stop: bool) -> bool:
        """Rank 0's ``stop``, on every rank: one element broadcast."""
        if self.world == 1:
            return stop
        import torch
        import torch.distributed as dist
        flag = torch.tensor([int(stop)], dtype=torch.int32,
                            device=self.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def over_ranks(self, memory_peak: int, summary: dict | None) -> tuple:
        """(the largest memory peak of the ranks, the number of ranks that
        reported); rank 0 writes each rank's peak and busy share to
        standard error."""
        if self.world == 1:
            return memory_peak, 1
        import sys

        import torch
        import torch.distributed as dist
        s = summary or {}
        mine = torch.tensor([float(memory_peak), s.get("busy_s", 0.0),
                             s.get("window_s", 0.0)], dtype=torch.float64,
                            device=self.device)
        rows = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(rows, mine)
        rows = [r.tolist() for r in rows]
        if self.rank == 0:
            for r, (peak, busy, win) in enumerate(rows):
                share = f"{100 * busy / win:.4f}%" if win else "not traced"
                print(f"rank {r}: memory_peak_bytes {int(peak)} busy_s "
                      f"{busy!r} window_s {win!r} busy share {share}",
                      file=sys.stderr, flush=True)
        return max(int(r[0]) for r in rows), len(rows)

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
    if the window is shorter).  On several ranks rank 0's clock ends the
    window: every rank runs the iterations rank 0 runs."""
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
        if ctx.decide(te >= deadline and i >= min_iters
                      and (prof is None or i > trace_iters)):
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
             t_start: float, mode: str = "program", make=None):
    """The result line of one run of ``cell`` (module docstring).
    ``make`` replaces the (scorer, trainer) factories: tests plant faults
    with it.  A cell of several chips runs in each of its ranks (one
    process per card, joined in ``torch.distributed``; ``ranks.py``), on
    the port's mesh that its traffic names; rank 0 returns the result
    line, the others None.  The control of such a cell needs no mesh: it
    runs in one process on one chip."""
    import torch
    import torch.distributed as dist
    if cell.config["dtype"] != "float32":
        raise ValueError(f"{cell.name}: the benchmark runs float32 (TF32 "
                         f"off) only, not {cell.config['dtype']!r}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != cell.chips and not (mode == "control" and world == 1):
        raise ValueError(f"{cell.name} runs as {cell.chips} rank(s), one "
                         f"per chip; this process is one of {world}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    family = S.family_module(cell.config)
    scorer, trainer = make or factories(mode, family, device)
    rank, mesh = 0, None
    if world > 1:
        if mode != "program":
            raise ValueError("the control runs in one process")
        from portbench import sut
        rank = dist.get_rank()
        mesh = sut.mesh(cell.traffic["mesh"], device)
        scorer = functools.partial(scorer, mesh=mesh)
    ctx = Context(cell, seed, seconds, trace, device, t_start, family,
                  scorer, trainer, rank, world, mesh)
    out = S.loop_module(cell.traffic).run(ctx)
    if out is None:
        return None
    checks = {name: {"value": value, "limit": cell.limits[name]}
              for name, value in out["readings"].items()}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": out["ranks"], "memory_peak_bytes": out["memory_peak_bytes"]}
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
                          out["traced"], peak_of(dev["kind"]), out["ranks"])
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
    its ``iters`` traced iterations (rank 0's, on several chips), the
    card's peaks (None for a card the table does not list) and the number
    of chips the run used."""
    cell: str
    config: dict
    traffic: dict
    trace: dict
    iters: int
    peak: dict | None
    chips: int = 1

    @property
    def loop(self) -> str:
        return self.traffic["loop"]


def check_lines(result: dict) -> list:
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in result["checks"].items()]
