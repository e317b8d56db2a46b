"""Continuous batching for the serving stack (port of
``repro/serve/batching.py``): a fixed pool of B slots, each slot owns a
position cursor inside the shared (stacked) caches; finished requests free
their slot, queued requests prefill into free slots.

Slot isolation:

  * Prefill runs on a **per-slot cache view** — ``caches[:, s:s+1]`` of
    every cache leaf is a view into the shared caches, so the prompt, run
    token by token by `prefill_step` as the JAX batcher runs it, writes
    that slot's entries in place and no other slot's.  The view's leaves
    that are not indexed by position (the Mamba2 state and conv tail,
    rwkv6's ``prev``, ``wkv`` and ``prev_cm``) are zeroed first, so a
    reused slot does not start from the previous request's state.
  * No audio: as in the JAX batcher, no request carries encoder frames,
    so whisper's cross-attention reads the zero ``xk``/``xv`` of
    `init_caches` and its cross term is exactly 0.  Audio is served by
    ``prefill_step(..., enc_frames=)`` then ``decode_step``.
  * Decode is **one batched step with per-row cursors**: every slot
    attends and writes at its *own* position (per-row RoPE positions,
    causal masks and cache writes).  Free slots decode inertly at cursor
    0; whatever they write is reset or overwritten by the next prefill
    before it can ever be read.

Everything runs on the device the model's parameters live on, under
``torch.no_grad()``.  With a ``mesh`` (``data`` extent 1) the model holds
the rank's tensor-parallel blocks (``init_params(..., mesh=)``): every
rank runs the batcher on the same requests, its caches hold every slot
and the rank's heads (``init_caches(..., mesh=)``), the reused slot's
state is zeroed on those local shapes, and each step runs under
``shardings.use_mesh(mesh)``.  A mesh whose data axes exceed 1 is
refused: the reference's batcher takes no mesh, so it has no rule for
splitting slots over data (nor for the sequence-split caches, whose
per-row cursors the batch of slots would need).  Telemetry is opt-in via ``telemetry=``
(`obs.live.ServeTelemetry`); the default `NULL_TELEMETRY` makes every
hook a no-op.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import shardings as SH
from repro_torch.models import transformer as T
from repro_torch.obs.live import NULL_TELEMETRY
from repro_torch.serve.serve_step import (decode_step, greedy_token,
                                         prefill_step)


#: Cache leaves not indexed by position: a reused slot zeroes them.
UNPOSITIONED = ("ssm", "conv", "prev", "wkv", "prev_cm")

#: The designed host sync points (``analysis/lint.check_host_sync``): the
#: first token a prefill samples (``add``) and each decode step's tokens
#: (``step``) feed the Python-side slot state.
_HOST_SYNC_OK = ("add", "step")


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (len,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    #: logits at the prompt's last position, from prefill
    logits: Optional[torch.Tensor] = None


class ContinuousBatcher:
    def __init__(self, model, cfg: ArchConfig, batch_slots: int,
                 max_len: int, telemetry=None, mesh=None):
        if SH.data_extent(mesh) != 1:
            raise NotImplementedError(
                f"the batcher keeps every slot on every rank: a mesh with "
                f"data axes of {SH.data_extent(mesh)} ranks is not served")
        self.model = model
        self.cfg = cfg
        self.b = batch_slots
        self.max_len = max_len
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.device = model.embed.device
        self.mesh = mesh
        self.caches = T.init_caches(cfg, batch_slots, max_len,
                                    dtype=model.embed.dtype,
                                    device=self.device, mesh=mesh)
        self.pos = np.zeros(batch_slots, dtype=np.int64)
        self.budget = np.zeros(batch_slots, dtype=np.int64)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.last_tok = np.zeros((batch_slots, 1), dtype=np.int32)

    def _on_mesh(self):
        return (contextlib.nullcontext() if self.mesh is None
                else SH.use_mesh(self.mesh))

    # -- slot cache views ----------------------------------------------------
    def _slot_view(self, s: int) -> dict:
        """Views of slot ``s``'s cache entries (writes land in place)."""
        return _map_leaves(lambda c: c[:, s:s + 1], self.caches)

    def _free_slot(self, s: int) -> None:
        self.slot_req[s] = None
        self.pos[s] = 0
        self.budget[s] = 0
        self.last_tok[s, 0] = 0

    def active_slots(self) -> List[int]:
        return [s for s in range(self.b) if self.slot_req[s] is not None]

    @torch.no_grad()
    def add(self, req: Request) -> bool:
        """Place ``req`` into a free slot (prefill); False when all busy."""
        if len(req.prompt) > self.max_len - 1:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds cache capacity "
                f"{self.max_len - 1}")
        if req.max_new <= 0 or len(req.prompt) == 0:
            req.done = True             # nothing to generate: never slotted
            return True
        tele = self.telemetry
        for s in range(self.b):
            if self.slot_req[s] is None:
                tele.started(req.rid, s, len(req.prompt),
                             active=len(self.active_slots()) + 1)
                view = self._slot_view(s)
                for name in UNPOSITIONED:
                    if name in view:
                        view[name].zero_()
                toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                       device=self.device)
                with self._on_mesh():
                    lg, _ = prefill_step(self.model, self.cfg, toks[None],
                                         view, stepwise=True)
                req.logits = lg[0]
                # reading the token waits for the card, so the hook after
                # it times the prefill's work, not only its launches
                first = int(lg[0].argmax())
                tele.prefilled(req.rid, s, len(req.prompt))
                req.out.append(first)
                self.pos[s] = len(req.prompt)
                if req.max_new == 1 or self.pos[s] >= self.max_len - 1:
                    req.done = True     # prefill token was the whole budget
                    tele.finished(req.rid, s, len(req.out))
                    return True
                self.slot_req[s] = req
                self.budget[s] = req.max_new - 1
                self.last_tok[s, 0] = first
                return True
        return False

    @torch.no_grad()
    def step(self, queue_depth: int = 0) -> List[Request]:
        """One decode step for every active slot; returns finished requests."""
        active = self.active_slots()
        if not active:
            return []
        tele = self.telemetry
        t0 = time.perf_counter() if tele.enabled else 0.0
        with self._on_mesh():
            logits, _ = decode_step(
                self.model, self.cfg,
                torch.as_tensor(self.last_tok, device=self.device),
                self.caches, torch.as_tensor(self.pos, device=self.device))
        nxt = greedy_token(logits).cpu().numpy()
        finished = []
        for s in active:
            req = self.slot_req[s]
            tok = int(nxt[s])
            req.out.append(tok)
            self.last_tok[s, 0] = tok
            self.pos[s] += 1
            self.budget[s] -= 1
            tele.tick(req.rid, s, tok)
            if self.budget[s] <= 0 or self.pos[s] >= self.max_len - 1:
                req.done = True
                finished.append(req)
                tele.finished(req.rid, s, len(req.out))
                self._free_slot(s)
        if tele.enabled:
            tele.step(len(active), len(self.active_slots()),
                      queue_depth=queue_depth,
                      step_s=time.perf_counter() - t0)
        return finished


def serve_stream(model, cfg: ArchConfig,
                 stream: Sequence[Tuple[int, Sequence[int], int]],
                 batch_slots: int = 4, max_len: int = 128,
                 telemetry=None, mesh=None) -> List[Request]:
    """Replay a request stream through the batcher until drained.

    ``stream``: (arrival_tick, prompt, max_new) triples; a tick is one
    batched decode step, so bursty traces interleave arrivals with decode
    progress exactly like a live server.  ``mesh``: as
    `ContinuousBatcher`'s.  Returns the Requests in stream order.
    """
    tele = telemetry if telemetry is not None else NULL_TELEMETRY
    reqs = [Request(i, np.asarray(p, np.int32), mn)
            for i, (_, p, mn) in enumerate(stream)]
    arrivals = sorted(range(len(reqs)), key=lambda i: (stream[i][0], i))
    batcher = ContinuousBatcher(model, cfg, batch_slots, max_len,
                                telemetry=tele, mesh=mesh)
    queue: List[Request] = []
    tick = 0
    i = 0
    while i < len(arrivals) or queue or batcher.active_slots():
        while i < len(arrivals) and stream[arrivals[i]][0] <= tick:
            req = reqs[arrivals[i]]
            queue.append(req)
            tele.enqueued(req.rid, len(queue))
            i += 1
        while queue and batcher.add(queue[0]):
            queue.pop(0)
        batcher.step(queue_depth=len(queue))
        tick += 1
    return reqs


def serve_requests(model, cfg: ArchConfig, prompts: list,
                   batch_slots: int = 4, max_len: int = 128,
                   max_new: int = 8, telemetry=None) -> list:
    """Drive the batcher until every request completes; returns Requests."""
    return serve_stream(model, cfg,
                        [(0, p, max_new) for p in prompts],
                        batch_slots=batch_slots, max_len=max_len,
                        telemetry=telemetry)
