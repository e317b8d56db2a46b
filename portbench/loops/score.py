"""Closed-loop scoring: one client sends a batch of ``batch`` sequences of
``seq_len`` tokens, waits for its logits, and sends the next.

Set-up draws the weights and a pool of ``pool`` distinct batches (plus one
for the warm-up) from the seed, builds the scorer on the weights, and
runs the warm-up batch once.  The window then sends the pool's batches in
order.  ``score_tokens_per_s`` counts every token of every completed batch
over the whole window.

The check: ``sample`` sequences of the first ``check_within`` batches
(which every window completes: it runs on until it has), drawn from the
seed as a systematic sample over their rows, so the sample spreads over
every part of a batch.  As each such batch completes, its sampled rows'
logits are copied to pinned host memory on a side stream, which overlaps
the next forward and holds no device memory.  After the window each
sampled row is run through the plain reference at float32 on the same
weights and tokens, and ``logits_gap`` is the largest
max |logits − reference| / max |reference| over the rows.  The pinned
buffer's allocation is the check's, not set-up's, and is not counted in
``setup_s``.

A cell of several chips (``"mesh"`` in its traffic, as {"data": 1,
"model": 4}) runs this loop in every rank on the port's mesh: each rank
draws its blocks of the weights one group at a time, and every rank
feeds the whole batch and gets the whole logits.  Set-up ends after a
barrier, so ``setup_s`` covers the slowest rank.  Rank 0 keeps the
sample, and after the window it alone runs the reference, on weights
drawn again one group at a time as it reads them (`C.Streamed`), so no
card has to hold the model whole; the other ranks return None.
"""
from __future__ import annotations

import random
import time

import torch

from portbench.harness import window
from portbench.reference import common as C


def sampled_rows(seed: int, batches: int, rows: int, k: int) -> list:
    """(batch, row) of ``k`` sequences of ``batches`` × ``rows``: every
    (batches·rows / k)-th, from an offset drawn from the seed."""
    n = batches * rows
    if not 1 <= k <= n:
        raise ValueError(f"cannot sample {k} of {n} sequences")
    step = n / k
    offset = random.Random(C.derive_seed(seed, "sample")).random() * step
    return [divmod(int(offset + j * step), rows) for j in range(k)]


def run(ctx) -> dict:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    rows, length, count = tr["batch"], tr["seq_len"], tr["pool"]
    within = tr["check_within"]
    if tr.get("mesh", {}).get("data", 1) != 1:
        raise ValueError("the score loop feeds every rank the whole batch: "
                         "it runs meshes whose data extent is 1")
    spec = ctx.family.spec(cfg)
    w = ctx.weights(spec)
    pool = C.token_pool(ctx.seed, count + 1, rows, length, cfg["vocab"], dev)
    scorer = ctx.scorer(cfg, tr, w)
    sample = sampled_rows(ctx.seed, within, rows, tr["sample"]) \
        if ctx.rank == 0 else []
    cuda = dev.type == "cuda"
    t = time.perf_counter()
    kept = torch.empty((len(sample), length, C.vocab_pad(cfg)),
                       dtype=torch.float32, pin_memory=cuda)
    check_s = time.perf_counter() - t
    copier = torch.cuda.Stream(dev) if cuda else None
    scorer.forward(pool[count])
    ctx.sync()
    ctx.barrier()
    setup_s = time.perf_counter() - ctx.t_start - check_s
    ctx.reset_peak()

    def iterate(i):
        logits = scorer.forward(pool[i % count])
        ctx.sync()
        picks = [(j, r) for j, (b, r) in enumerate(sample) if b == i]
        if picks and cuda:
            copier.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(copier):
                for j, r in picks:
                    kept[j].copy_(logits[r], non_blocking=True)
            logits.record_stream(copier)
        elif picks:
            for j, r in picks:
                kept[j].copy_(logits[r])

    win = window(ctx, iterate, tr["trace_iters"], min_iters=within)
    ctx.sync()                            # the last copies have landed
    memory_peak, ranks = ctx.over_ranks(ctx.memory_peak(), win["trace"])
    del scorer
    if ctx.mesh is not None:
        del w
        if ctx.rank:
            ctx.free()
            return None
        w = C.Streamed(spec, ctx.seed, dev)
    ctx.free()
    gap = 0.0
    with torch.no_grad(), C.precision("f32", dev):
        for j, (b, r) in enumerate(sample):
            ref = ctx.family.forward(w, cfg, pool[b][r:r + 1])[0]
            gap = max(gap, float((kept[j].to(dev) - ref).abs().max()
                                 / ref.abs().max()))
            del ref
    return {"setup_s": setup_s,
            "end_to_end": {
                "score_tokens_per_s": win["count"] * rows * length
                / win["window_s"]},
            "attempted": win["count"] * rows, "failed": 0,
            "readings": {"logits_gap": gap},
            "memory_peak_bytes": memory_peak, "ranks": ranks,
            "trace": win["trace"], "traced": win["traced"]}
