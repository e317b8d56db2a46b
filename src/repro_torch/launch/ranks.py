"""Several ranks of one ``torch.distributed`` world on this host.

`spawn` starts a program as ``world`` processes and waits for them;
each process calls `join` first.  The ranks meet through a ``file://``
store (no network): on CUDA rank r takes card r and the ranks join with
NCCL, on the CPU with gloo.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Sequence


def rank_env(src: Path, **extra) -> dict:
    """This process's environment for a rank: ``src`` on the Python path,
    one OpenMP thread, NCCL on the loopback interface, then ``extra``."""
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1",
               NCCL_SOCKET_IFNAME="lo")
    env.update(extra)
    return env


def spawn(args_of: Callable[[int], Sequence[str]], world: int,
          logs: Sequence[Path], timeout: float, store: Path,
          env: Optional[dict] = None, echo: Optional[int] = None) -> list:
    """Run ``world`` processes, rank r being ``python *args_of(r)`` with
    its output in the file ``logs[r]`` (rank ``echo``'s on this process's
    standard output), until every one has exited, one has exited non-zero
    (the others would wait for it) or ``timeout`` seconds have passed;
    then kill and reap every one.  ``store`` (the ranks' ``file://``
    store) is removed first: a stale one would mix two worlds.  Returns
    the exit codes (negative where a process was killed)."""
    Path(store).unlink(missing_ok=True)
    files = [None if r == echo else open(logs[r], "w") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, *args_of(r)], env=env, stdout=files[r],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in files:
            if f is not None:
                f.close()
    return [p.returncode for p in procs]


def join(rank: int, world: int, store: str, device: str,
         timeout: Optional[float] = None) -> str:
    """Join the world as ``rank`` through the ``file://`` store ``store``
    and return the rank's device: ``device`` "cuda" takes card ``rank``
    and NCCL, "cpu" one thread and gloo.  ``timeout`` bounds one
    collective (seconds; None: the backend's default)."""
    import torch
    import torch.distributed as dist
    if device == "cpu":
        torch.set_num_threads(1)
        dev = "cpu"
    else:
        torch.cuda.set_device(rank)
        dev = f"cuda:{rank}"
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group("gloo" if dev == "cpu" else "nccl",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world, **kw)
    return dev
