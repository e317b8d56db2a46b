"""Closed-loop training: one optimizer step after another on batches of
``global_batch`` rows of ``seq_len`` + 1 tokens (inputs and next-token
labels), each step split into ``microbatches``.

Set-up draws the weights and a pool of ``pool`` distinct batches from the
seed, builds the trainer (model and optimizer state) on the weights, and
drives it through its first ``check_steps`` steps, which are also its
warm-up; the same trainer then runs the window on the following batches.
``train_tokens_per_s`` counts the tokens of every step completed in the
window over the whole window.

The check, after the window, on a plain reference trainer that starts
from the same weights (drawn again from the seed) and takes the same
first ``check_steps`` batches:
  loss_gap    the largest |loss − reference| / |reference| of those steps;
  grad_gap    over the leaves, the gap between the norms of the first
              step's gradient as AdamW took it (clipped; the trainer's is
              read back from its first moment), over the larger of the
              reference's norm of that leaf and of the median leaf;
  change_gap  the same of each leaf's change after ``check_steps`` steps,
              over the leaves whose reference gradient is at least 1e-3
              of the median leaf's (a gradient that is nought to rounding
              moves its leaf under Adam by rounding alone).
The trainer's norms are read during set-up, and that time is not counted
in ``setup_s``.
"""
from __future__ import annotations

import statistics
import time

import torch

from portbench.harness import window
from portbench.reference import common as C
from portbench.reference import train as RT

NOUGHT = 1e-3


def change_norms(params: dict, spec: list, seed: int, device) -> dict:
    """{leaf: ‖now − start‖}, the start drawn again one group at a time."""
    out = {}
    for group in C.groups_of(spec):
        start = C.draw(spec, seed, device, only=group)
        for name, t in start.items():
            out[name] = (params[name].float() - t).norm()
        del start
    return out


def floats(d: dict) -> dict:
    names = list(d)
    values = torch.stack([d[n].float() for n in names]).tolist()
    return dict(zip(names, values))


def worst_gap(prog: dict, ref: dict, names) -> float:
    names = list(names)
    floor = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names)


def trajectory(trainer, pool, steps: int, spec, seed, device, sync):
    """Losses, first-step gradient norms and changes of ``steps`` steps of
    ``trainer``, and the seconds spent reading them."""
    losses, first, read_s = [], None, 0.0
    for k in range(steps):
        losses.append(trainer.step(pool[k]))
        if k == 0:
            sync()                        # the step's own time is set-up
            t = time.perf_counter()
            first = floats(trainer.first_grad_norms())
            read_s += time.perf_counter() - t
    sync()
    t = time.perf_counter()
    change = floats(change_norms(trainer.params(), spec, seed, device))
    losses = [float(v) for v in losses]
    read_s += time.perf_counter() - t
    return losses, first, change, read_s


def run(ctx) -> dict:
    if ctx.world > 1:
        raise ValueError(f"{ctx.cell.name}: the train loop runs on one chip")
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    rows, length, count = tr["global_batch"], tr["seq_len"], tr["pool"]
    steps = tr["check_steps"]
    spec = ctx.family.spec(cfg)
    pool = C.token_pool(ctx.seed, count, rows, length + 1, cfg["vocab"], dev)
    trainer = ctx.trainer(cfg, tr, C.draw(spec, ctx.seed, dev))
    losses, first, change, read_s = trajectory(trainer, pool, steps, spec,
                                               ctx.seed, dev, ctx.sync)
    setup_s = time.perf_counter() - ctx.t_start - read_s
    ctx.reset_peak()

    def iterate(i):
        trainer.step(pool[(steps + i) % count])
        ctx.sync()

    win = window(ctx, iterate, tr["trace_iters"])
    memory_peak = ctx.memory_peak()
    del trainer
    ctx.free()
    with C.precision("f32", dev):
        ref = RT.Trainer(ctx.family, cfg, tr, C.draw(spec, ctx.seed, dev))
        r_losses, r_first, r_change, _ = trajectory(ref, pool, steps, spec,
                                                    ctx.seed, dev, ctx.sync)
    del ref
    ctx.free()
    floor = statistics.median(r_first.values())
    moved = [n for n in r_first if r_first[n] >= NOUGHT * floor]
    readings = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
        "grad_gap": worst_gap(first, r_first, r_first),
        "change_gap": worst_gap(change, r_change, moved)}
    return {"setup_s": setup_s,
            "end_to_end": {"train_tokens_per_s": win["count"] * rows * length
                           / win["window_s"]},
            "attempted": win["count"], "failed": 0,
            "readings": readings, "memory_peak_bytes": memory_peak,
            "ranks": 1,
            "trace": win["trace"], "traced": win["traced"]}
