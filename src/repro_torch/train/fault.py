"""Fault tolerance & straggler mitigation around the training loop (port
of ``repro/train/fault.py``).

* ``Watchdog``: per-step wall-time tracking; a step slower than
  ``straggler_factor`` × rolling median flags a straggler (at multi-host
  scale the runner would evict/replace that host and trigger elastic
  resume; here the signal is surfaced + logged).
* ``run_resilient``: checkpoint every N steps, restart from the latest
  checkpoint after an (injected or real) failure, replaying the data
  stream deterministically from the restored step.  The step updates the
  model and optimizer state in place, and a restart restores into them.
  Under a mesh (``shardings.use_mesh``) every rank gathers its blocks
  into the checkpoint's whole leaves, rank 0 writes them, every rank
  waits for it, and every rank restores its blocks.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models import shardings as SH
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class Watchdog:
    straggler_factor: float = 3.0
    window: int = 32
    _times: deque = dataclasses.field(default_factory=lambda: deque(maxlen=64))
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self._times) >= 8:
            med = float(np.median(self._times))
            if dt > self.straggler_factor * med:
                self.stragglers += 1
                is_straggler = True
        self._times.append(dt)
        return is_straggler


def _sync(model) -> None:
    """Wait for the model's device: a CUDA step returns before the card
    has finished, and a clock stopped then times the enqueue."""
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _save(ckpt_dir: str, step: int, state, metrics: dict) -> None:
    """Rank 0 of the current mesh (or the only process) writes the
    checkpoint, every rank giving its blocks of the sharded leaves; the
    other ranks wait until it is complete."""
    mesh = SH.current_mesh()
    ckpt.save(ckpt_dir, step, state,
              extra={"metrics": {k: float(v) for k, v in metrics.items()}},
              write=mesh is None or mesh.rank == 0)
    if mesh is not None:
        mesh.agree(True)


def run_resilient(train_step: Callable, model, opt_state, data_iter_fn,
                  n_steps: int, ckpt_dir: str, ckpt_every: int = 20,
                  fail_at: Optional[int] = None, max_restarts: int = 3,
                  log: Optional[Callable] = None):
    """Run ``n_steps`` with checkpoint/restart; returns (model, opt_state,
    {"restarts", "stragglers"}).  ``fail_at`` injects a crash once (tests
    the recovery path).  data_iter_fn(start_step) must replay
    deterministically."""
    state = (model, opt_state)
    start = ckpt.latest_step(ckpt_dir) or 0
    if start:
        ckpt.restore(ckpt_dir, state, step=start)
    restarts = 0
    failed_once = False
    wd = Watchdog()
    step = start
    while step < n_steps:
        try:
            it = data_iter_fn(step)
            while step < n_steps:
                batch = next(it)
                if fail_at is not None and step == fail_at and not failed_once:
                    failed_once = True
                    raise RuntimeError(f"injected failure at step {step}")
                _sync(model)
                t0 = time.monotonic()
                model, opt_state, metrics = train_step(model, opt_state,
                                                       batch)
                _sync(model)
                dt = time.monotonic() - t0
                if wd.observe(dt) and log:
                    log(f"straggler at step {step}: {dt:.3f}s")
                step += 1
                if step % ckpt_every == 0 or step == n_steps:
                    _save(ckpt_dir, step, (model, opt_state), metrics)
                if log:
                    log(f"step {step} loss {float(metrics['loss']):.4f}")
        except RuntimeError as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            if log:
                log(f"FAILURE ({e}); restart {restarts} from latest ckpt")
            last = ckpt.latest_step(ckpt_dir)
            if last:
                ckpt.restore(ckpt_dir, (model, opt_state), step=last)
                step = last
            else:
                step = 0
    return model, opt_state, {"restarts": restarts,
                              "stragglers": wd.stragglers}
