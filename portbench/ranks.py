#!/usr/bin/env python3
"""A cell of several chips, run as one process per card.

`launch` writes the cell to its run directory, starts ``cell.chips``
ranks of this file and waits for them.  The ranks meet through a
``file://`` store in that directory (no network): rank r takes card r and
the ranks join over NCCL (on the CPU, in tests, over gloo), with every
collective bounded by `COLLECTIVE_TIMEOUT_S`, so a rank that stops
answering fails the others.  Each rank runs the cell (`harness.run_cell`)
and checks that no forbidden module was loaded; rank 0 alone writes the
result line.  The launcher hands it on only when every rank exited 0: a
rank that exits non-zero, or a run longer than `RUN_LIMIT_S`, ends every
rank, and the run gives no result line.

The launcher's pattern is ``repro_torch/launch/ranks.py``'s ``spawn`` and
``join``, kept here so that only ``sut.py`` imports the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: seconds one collective may wait for the other ranks before its rank fails
COLLECTIVE_TIMEOUT_S = 300
#: seconds the whole run may take (the first run in a checkout builds)
RUN_LIMIT_S = 1140


def spawn(args_of, world: int, run_dir: Path, timeout: float,
          env: dict) -> list:
    """Run ``world`` processes, rank r being ``python *args_of(r)`` with its
    standard output in ``run_dir/rank<r>.out`` and its errors in
    ``rank<r>.err``, until every one has exited, one has exited non-zero
    (the others would wait for it) or ``timeout`` seconds have passed; then
    kill and reap every one with whatever it started.  Returns the exit
    codes (negative where a process was killed)."""
    files, procs = [], []
    try:
        for r in range(world):
            out = open(run_dir / f"rank{r}.out", "w")
            err = open(run_dir / f"rank{r}.err", "w")
            files += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, *args_of(r)], env=env, stdout=out,
                stderr=err, start_new_session=True))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            p.wait()
        for f in files:
            f.close()
    return [p.returncode for p in procs]


def launch(cell, seed: int, seconds: float, trace: bool, device: str,
           t_start: float, run_dir: Path, fault: str | None = None,
           collective_timeout: float = COLLECTIVE_TIMEOUT_S) -> tuple:
    """Run ``cell`` as ``cell.chips`` ranks on ``device`` ("cuda" or
    "cpu"); ``t_start`` is this process's ``perf_counter`` at its start,
    from which the ranks count ``setup_s``.  ``fault`` plants a fault of
    `faults` in every rank.  Returns (exit codes, rank 0's standard output,
    its standard error); the output holds the result line only where
    every code is 0."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    store = run_dir / "store"
    store.unlink(missing_ok=True)         # a stale store would mix two runs
    cell_file = run_dir / "cell.json"
    cell_file.write_text(json.dumps(dataclasses.asdict(cell)))
    t0 = time.monotonic() - (time.perf_counter() - t_start)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]), NCCL_SOCKET_IFNAME="lo")

    def args_of(r):
        return [str(Path(__file__).resolve()), "--cell", str(cell_file),
                "--seed", str(seed), "--seconds", str(seconds),
                "--trace", str(int(trace)), "--rank", str(r), "--store",
                str(store), "--device", device, "--t0", repr(t0),
                "--timeout", repr(float(collective_timeout))] + (
                    ["--fault", fault] if fault else [])

    codes = spawn(args_of, cell.chips, run_dir, RUN_LIMIT_S, env)
    out = (run_dir / "rank0.out").read_text()
    err = (run_dir / "rank0.err").read_text()
    if any(codes):
        out = ""
        err += "".join(
            f"error: rank {r} exited {c}; the end of its errors:\n"
            f"{(run_dir / f'rank{r}.err').read_text()[-4000:]}\n"
            for r, c in enumerate(codes) if c)
    return codes, out, err


def join(rank: int, world: int, store: str, device: str,
         timeout: float) -> str:
    """Join the world as ``rank`` through the ``file://`` store ``store``
    and return the rank's device: card ``rank`` over NCCL for "cuda", one
    thread over gloo for "cpu"; one collective waits ``timeout`` seconds
    at most."""
    import torch
    import torch.distributed as dist
    if device == "cpu":
        torch.set_num_threads(1)
        dev = "cpu"
    else:
        torch.cuda.set_device(rank)
        dev = f"cuda:{rank}"
    bound = datetime.timedelta(seconds=timeout)
    # the port's mesh makes its subgroups (dist.new_group) with torch's
    # default timeout, half an hour or more: bound them as the world
    dist.distributed_c10d.default_pg_timeout = bound
    dist.distributed_c10d.default_pg_nccl_timeout = bound
    dist.init_process_group("gloo" if dev == "cpu" else "nccl",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=bound)
    return dev


def rank_main(argv=None) -> int:
    """One rank of `launch`'s run."""
    ap = argparse.ArgumentParser(description="one rank of a cell's run")
    for name, kind in (("--cell", str), ("--seed", int), ("--seconds", float),
                       ("--trace", int), ("--rank", int), ("--store", str),
                       ("--device", str), ("--t0", float),
                       ("--timeout", float)):
        ap.add_argument(name, type=kind, required=True)
    ap.add_argument("--fault")
    args = ap.parse_args(argv)
    t_start = time.perf_counter() - (time.monotonic() - args.t0)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch.distributed as dist
    from portbench import faults, harness, run, spec
    cell = spec.Cell(**json.loads(Path(args.cell).read_text()))
    dev = join(args.rank, cell.chips, args.store, args.device, args.timeout)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), dev, t_start,
                              make=faults.make(args.fault) if args.fault
                              else None)
    found = run.loaded_forbidden()
    if found:
        print(f"error: rank {args.rank} loaded these modules: {found}",
              file=sys.stderr, flush=True)
        return 3
    dist.destroy_process_group()
    if result is not None:
        print("\n".join(harness.check_lines(result)), file=sys.stderr,
              flush=True)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
