"""repro_torch.obs.live — streaming serve-path telemetry (DESIGN.md §13),
the JAX package's ``obs/live.py`` on the port's recorder, graph and
hypergraph.  Everything here is host numpy and Python floats, the same
arithmetic in the same order, so every output equals the JAX package's
bit for bit.

Three layers on top of the recorder:

  * **Streaming metric primitives** — `WindowedCounter` (time-bucketed
    totals with exact rollover), `EwmaRate` (exponentially-decayed rate
    gauge) and `QuantileSketch` (Greenwald–Khanna ε-approximate quantiles,
    deterministic worst-case rank error ≤ εn + 1).  All host-only.
  * **`ServeTelemetry`** — the per-run aggregation object the serving
    stack threads through: per-request queue/prefill/decode/end-to-end
    latency sketches, tokens-per-second throughput, queue-depth /
    slot-occupancy gauges, and per-slot request span emission onto the
    recorder's named tracks (Chrome-trace export → a Perfetto timeline
    with one row per slot).
  * **`TrafficAccumulator`** — the live traffic hypergraph: observed MoE
    gate indices (and KV co-access sets) fold incrementally into decayed
    co-activation pin weights; `snapshot()` materialises the window as a
    `Hypergraph` ((λ−1) == replication / all-to-all traffic) ready for
    ``kahypar``, and `drift()` scores the live window against the
    partition-time baseline so a serving loop knows when the incumbent
    partition has gone stale (`advise()` flips the
    ``serve/repartition_advised`` gauge).

Disabled path: `NULL_TELEMETRY` follows the NULL-recorder contract — every
method is a no-op, so an uninstrumented serve run never takes a clock
reading, allocates an event, or syncs the device.  The MoE gate tap
(``models.moe.observe_gates``) copies the routing decision to the host
only while a sink is installed.
"""
from __future__ import annotations

import bisect
import math
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.recorder import NULL, Recorder


# ---------------------------------------------------------------------------
# streaming metric primitives
# ---------------------------------------------------------------------------

class WindowedCounter:
    """A sliding-window counter over fixed time buckets.

    The window is bucket-aligned: ``total(now)`` is the exact sum of every
    ``add(value, t)`` whose bucket index lies in the last ``buckets``
    bucket epochs ending at ``now``'s bucket (inclusive).  Rollover is
    exact — a bucket is zeroed the moment it is reused for a new epoch, so
    stale values can never leak back into the window.
    """

    def __init__(self, window_s: float = 10.0, buckets: int = 20,
                 clock=time.monotonic):
        if window_s <= 0 or buckets <= 0:
            raise ValueError("window_s and buckets must be positive")
        self.window_s = float(window_s)
        self.buckets = int(buckets)
        self.bucket_w = self.window_s / self.buckets
        self._clock = clock
        self._vals = [0.0] * self.buckets
        self._epoch = [-1] * self.buckets        # bucket index each slot holds

    def _idx(self, now: float) -> int:
        return int(math.floor(now / self.bucket_w))

    def add(self, value: float = 1.0, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        idx = self._idx(now)
        slot = idx % self.buckets
        if self._epoch[slot] != idx:
            self._vals[slot] = 0.0
            self._epoch[slot] = idx
        self._vals[slot] += value

    def total(self, now: Optional[float] = None) -> float:
        now = self._clock() if now is None else now
        idx = self._idx(now)
        lo = idx - self.buckets
        return sum(v for v, e in zip(self._vals, self._epoch)
                   if lo < e <= idx)

    def rate(self, now: Optional[float] = None) -> float:
        """Events per second over the window."""
        return self.total(now) / self.window_s


class EwmaRate:
    """Exponentially-weighted rate gauge (events/sec, halflife-decayed).

    Each ``update(value, now)`` folds the instantaneous rate
    ``value / dt`` in with weight ``1 − exp(−dt/τ)``; from a cold start
    under a constant event rate the estimate converges monotonically to
    the true rate.  ``value(now)`` additionally decays toward zero while
    no events arrive, so it is safe to export as a live gauge.
    """

    def __init__(self, halflife_s: float = 5.0, clock=time.monotonic):
        if halflife_s <= 0:
            raise ValueError("halflife_s must be positive")
        self.tau = halflife_s / math.log(2.0)
        self._clock = clock
        self._rate = 0.0
        self._last: Optional[float] = None

    def update(self, value: float = 1.0,
               now: Optional[float] = None) -> float:
        now = self._clock() if now is None else now
        if self._last is None:
            self._last = now
            return self._rate
        dt = now - self._last
        self._last = now
        if dt <= 0:
            # coincident events: fold into the current estimate as a burst
            self._rate += value / self.tau
            return self._rate
        alpha = math.exp(-dt / self.tau)
        self._rate = self._rate * alpha + (value / dt) * (1.0 - alpha)
        return self._rate

    def value(self, now: Optional[float] = None) -> float:
        if self._last is None:
            return 0.0
        now = self._clock() if now is None else now
        dt = max(now - self._last, 0.0)
        return self._rate * math.exp(-dt / self.tau)


class QuantileSketch:
    """Greenwald–Khanna ε-approximate streaming quantiles.

    Deterministic worst-case guarantee: ``query(q)`` returns a value whose
    rank in the observed stream is within ``eps * n + 1`` of ``q * n``,
    using O((1/ε)·log(εn)) space.  A value that occurs several times has
    a rank interval (from the count of smaller values to the count of
    values not larger), and the bound holds for some rank in it.  This is the bounded-error sketch behind the
    serve path's p50/p95/p99 latency gauges.
    """

    def __init__(self, eps: float = 0.01):
        if not (0 < eps < 0.5):
            raise ValueError("eps must be in (0, 0.5)")
        self.eps = eps
        self.n = 0
        # parallel arrays: values (sorted), g (rank gap), delta (uncertainty)
        self._v: List[float] = []
        self._g: List[int] = []
        self._d: List[int] = []
        self._since_compress = 0
        self._compress_every = max(1, int(1.0 / (2.0 * eps)))
        self._min = math.inf
        self._max = -math.inf

    def add(self, x: float) -> None:
        x = float(x)
        self._min = min(self._min, x)
        self._max = max(self._max, x)
        i = bisect.bisect_left(self._v, x)
        if i == 0 or i == len(self._v):
            delta = 0
        else:
            delta = int(math.floor(2.0 * self.eps * self.n))
        self._v.insert(i, x)
        self._g.insert(i, 1)
        self._d.insert(i, delta)
        self.n += 1
        self._since_compress += 1
        if self._since_compress >= self._compress_every:
            self._compress()
            self._since_compress = 0

    def _compress(self) -> None:
        thresh = int(math.floor(2.0 * self.eps * self.n))
        v, g, d = self._v, self._g, self._d
        i = len(v) - 2
        while i >= 1:
            if g[i] + g[i + 1] + d[i + 1] <= thresh:
                g[i + 1] += g[i]
                del v[i], g[i], d[i]
            i -= 1

    def query(self, q: float) -> float:
        """The ε-approximate q-quantile of everything added so far."""
        if self.n == 0:
            return math.nan
        if q <= 0:
            return self._min
        if q >= 1:
            return self._max
        r = max(1, int(math.ceil(q * self.n)))
        bound = r + self.eps * self.n
        rmin = 0
        prev = self._v[0]
        for v, g, d in zip(self._v, self._g, self._d):
            rmin += g
            if rmin + d > bound:
                return prev
            prev = v
        return self._v[-1]

    def quantiles(self, qs: Sequence[float] = (0.5, 0.95, 0.99)
                  ) -> Dict[str, float]:
        return {f"p{int(round(q * 100))}": self.query(q) for q in qs}


# ---------------------------------------------------------------------------
# the live traffic hypergraph
# ---------------------------------------------------------------------------

class TrafficAccumulator:
    """Decayed co-activation pin weights from observed routing traffic.

    `observe(gate_idx)` folds one batch of MoE routing decisions
    ``(..., k)`` into a pairwise co-activation matrix and a per-expert
    load vector; `observe_sets(sets)` folds KV co-access sets (any pin
    cardinality ≥ 2) into a bounded decayed net dictionary.  Every fold
    first multiplies the standing weights by ``decay`` — at ``decay=1``
    the accumulator is exactly the batch-mode
    ``moe.coactivation_graph`` over the concatenated stream (`to_graph`
    is constructed identically); at ``decay<1`` it is the exponentially
    weighted live window.

    `snapshot()` materialises the window as a `Hypergraph`
    (``Hypergraph.from_coactivation``), `set_baseline()` freezes the
    partition-time traffic histogram, and `drift()` is the total-variation
    distance between the baseline and the live window (max over the load
    and co-activation distributions), in [0, 1].
    """

    def __init__(self, n_items: int, decay: float = 0.95,
                 max_sets: int = 4096):
        if not (0 < decay <= 1):
            raise ValueError("decay must be in (0, 1]")
        self.n_items = int(n_items)
        self.decay = float(decay)
        self.max_sets = int(max_sets)
        self.pair = np.zeros((n_items, n_items), dtype=np.float64)
        self.load = np.zeros(n_items, dtype=np.float64)
        self.sets: Dict[Tuple[int, ...], float] = {}
        self.updates = 0
        self.events = 0
        self._base_load: Optional[np.ndarray] = None
        self._base_pair: Optional[np.ndarray] = None

    # -- folding ------------------------------------------------------------
    def _decay_all(self) -> None:
        if self.decay < 1.0:
            self.pair *= self.decay
            self.load *= self.decay
            if self.sets:
                dead = []
                for key in self.sets:
                    w = self.sets[key] * self.decay
                    if w < 1e-6:
                        dead.append(key)
                    else:
                        self.sets[key] = w
                for key in dead:
                    del self.sets[key]
        self.updates += 1

    def observe(self, gate_idx) -> None:
        """Fold one batch of routing decisions, shape (..., k) int."""
        idx = np.asarray(gate_idx)
        if idx.size == 0:
            return
        idx = idx.reshape(-1, idx.shape[-1]).astype(np.int64)
        self._decay_all()
        t, k = idx.shape
        self.events += t
        for i in range(k):
            for j in range(i + 1, k):
                np.add.at(self.pair, (idx[:, i], idx[:, j]), 1.0)
        self.load += np.bincount(idx.reshape(-1),
                                 minlength=self.n_items).astype(np.float64)

    def observe_sets(self, sets: Iterable[Sequence[int]]) -> None:
        """Fold co-access sets (e.g. KV pages touched by one request)."""
        self._decay_all()
        for s in sets:
            key = tuple(sorted(set(int(x) for x in s)))
            if len(key) < 2:
                continue
            self.events += 1
            self.sets[key] = self.sets.get(key, 0.0) + 1.0
            for v in key:
                self.load[v] += 1.0
        if len(self.sets) > self.max_sets:
            keep = sorted(self.sets.items(), key=lambda kv: -kv[1])
            self.sets = dict(keep[:self.max_sets])

    # -- materialisation ----------------------------------------------------
    def to_graph(self):
        """The co-activation `Graph` (identical construction to the batch
        ``moe.coactivation_graph`` when ``decay=1``)."""
        from repro_torch.core.csr import Graph
        n = self.n_items
        cnt = self.pair + self.pair.T
        u, v = np.triu_indices(n, 1)
        w = np.rint(cnt[u, v]).astype(np.int64)
        keep = w > 0
        load = np.rint(self.load).astype(np.int64)
        return Graph.from_edges(n, u[keep], v[keep], w[keep],
                                vwgt=np.maximum(load, 1))

    def snapshot(self, min_weight: float = 0.5):
        """The live traffic window as a `Hypergraph` (pins = items)."""
        from repro_torch.core.hypergraph.container import Hypergraph
        return Hypergraph.from_coactivation(
            self.pair + self.pair.T, load=self.load, sets=self.sets,
            min_weight=min_weight)

    # -- drift --------------------------------------------------------------
    @staticmethod
    def _normalize(x: np.ndarray) -> Optional[np.ndarray]:
        s = x.sum()
        return None if s <= 0 else x / s

    def _histograms(self):
        pair = self.pair + self.pair.T
        tri = pair[np.triu_indices(self.n_items, 1)]
        return self._normalize(self.load.copy()), self._normalize(tri)

    def set_baseline(self) -> None:
        """Freeze the current window as the partition-time histogram."""
        self._base_load, self._base_pair = self._histograms()

    def drift(self) -> float:
        """Total-variation distance live vs. baseline, in [0, 1]."""
        load, pair = self._histograms()
        d = 0.0
        for base, cur in ((self._base_load, load), (self._base_pair, pair)):
            if base is not None and cur is not None:
                d = max(d, 0.5 * float(np.abs(base - cur).sum()))
        return d

    def advise(self, recorder: Recorder = NULL,
               threshold: float = 0.3) -> bool:
        """Export drift gauges; True when repartitioning looks worthwhile."""
        d = self.drift()
        advised = d > threshold
        recorder.gauge("serve/traffic_drift", d)
        recorder.gauge("serve/repartition_advised", float(advised))
        return advised


# ---------------------------------------------------------------------------
# serve-path telemetry
# ---------------------------------------------------------------------------

class _NullTelemetry:
    """No-op telemetry (the default): the serve path pays one attribute
    access per hook, never a clock read or an allocation."""

    __slots__ = ()
    enabled = False
    traffic = None

    def enqueued(self, rid, queue_depth=0):
        pass

    def started(self, rid, slot, prompt_len, active=0):
        pass

    def prefilled(self, rid, slot, prompt_len=0):
        pass

    def step(self, new_tokens, active, queue_depth=0, step_s=None):
        pass

    def tick(self, rid, slot, token):
        pass

    def finished(self, rid, slot, n_out=0):
        pass

    def snapshot(self):
        return {}


NULL_TELEMETRY = _NullTelemetry()


class ServeTelemetry:
    """Streaming serve metrics + per-slot request tracing.

    Hooks (called by `ContinuousBatcher` / `serve_stream`):
      ``enqueued → started → prefilled → step* → finished``.

    Each request becomes a span on the named track ``slot <s>`` (visible
    as one Perfetto row per slot), with nested prefill/decode phases and
    per-tick token instants; queue depth, active slots and throughput are
    exported as counter tracks.  Latency distributions ride
    `QuantileSketch` (bounded rank error), throughput rides
    `WindowedCounter` + `EwmaRate`.

    ``traffic`` optionally carries a `TrafficAccumulator`; the serve loop
    calls ``advise()`` on it periodically via ``maybe_advise``.
    """

    enabled = True

    def __init__(self, recorder: Recorder = NULL,
                 traffic: Optional[TrafficAccumulator] = None,
                 window_s: float = 10.0, sketch_eps: float = 0.01,
                 ewma_halflife_s: float = 2.0, clock=time.perf_counter,
                 advise_every: int = 16, drift_threshold: float = 0.3):
        self.rec = recorder
        self.traffic = traffic
        self._clock = clock
        self.sketches: Dict[str, QuantileSketch] = {
            "queue_us": QuantileSketch(sketch_eps),
            "prefill_us": QuantileSketch(sketch_eps),
            "decode_us": QuantileSketch(sketch_eps),
            "e2e_us": QuantileSketch(sketch_eps),
        }
        self.tokens = WindowedCounter(window_s, clock=clock)
        self.requests = WindowedCounter(window_s, clock=clock)
        self.tok_rate = EwmaRate(ewma_halflife_s, clock=clock)
        self.advise_every = advise_every
        self.drift_threshold = drift_threshold
        self._t_enq: Dict[Any, float] = {}
        self._t_start: Dict[Any, float] = {}
        self._t_prefilled: Dict[Any, float] = {}
        self._steps = 0
        self.total_tokens = 0
        self.total_requests = 0

    # -- request lifecycle ---------------------------------------------------
    def enqueued(self, rid, queue_depth: int = 0) -> None:
        now = self._clock()
        self._t_enq[rid] = now
        self.rec.instant("enqueue", track="queue", rid=rid)
        self.rec.gauge("serve/queue_depth", queue_depth)

    def started(self, rid, slot, prompt_len: int, active: int = 0) -> None:
        now = self._clock()
        t_enq = self._t_enq.pop(rid, now)
        wait_us = (now - t_enq) * 1e6
        self.sketches["queue_us"].add(wait_us)
        self._t_start[rid] = t_enq          # e2e is enqueue → finish
        self.rec.begin(f"req {rid}", track=f"slot {slot}", rid=rid,
                       prompt_len=prompt_len, queue_us=round(wait_us, 1))
        self.rec.begin("prefill", track=f"slot {slot}", rid=rid)
        self.rec.gauge("serve/slots_active", active)
        self._t_prefilled[rid] = now

    def prefilled(self, rid, slot, prompt_len: int = 0) -> None:
        now = self._clock()
        t0 = self._t_prefilled.pop(rid, now)
        self.sketches["prefill_us"].add((now - t0) * 1e6)
        self.rec.end("prefill", track=f"slot {slot}")
        self.rec.begin("decode", track=f"slot {slot}", rid=rid)
        if prompt_len:
            self.rec.count("serve/prefill_tokens", prompt_len)
        # prefill yields the request's first generated token (the argmax
        # over the last prompt position) — count it with the output stream
        self.total_tokens += 1
        self.tokens.add(1.0, now=now)
        self.rec.count("serve/tokens", 1)

    def step(self, new_tokens: int, active: int, queue_depth: int = 0,
             step_s: Optional[float] = None) -> None:
        """One batched decode tick: ``new_tokens`` over ``active`` slots."""
        now = self._clock()
        self._steps += 1
        self.total_tokens += new_tokens
        if step_s is not None and new_tokens:
            per_tok_us = step_s * 1e6 / max(new_tokens, 1)
            self.sketches["decode_us"].add(per_tok_us)
        self.tokens.add(new_tokens, now=now)
        rate = self.tok_rate.update(new_tokens, now=now)
        self.rec.count("serve/tokens", new_tokens)
        self.rec.gauge("serve/slots_active", active)
        self.rec.gauge("serve/queue_depth", queue_depth)
        self.rec.gauge("serve/tok_per_s", rate)
        if self.traffic is not None and self.advise_every and \
                self._steps % self.advise_every == 0:
            self.traffic.advise(self.rec, self.drift_threshold)

    def tick(self, rid, slot, token: int) -> None:
        """Per-slot token instant (one marker per decode tick per slot)."""
        self.rec.instant("tok", track=f"slot {slot}", rid=rid, token=token)

    def finished(self, rid, slot, n_out: int = 0) -> None:
        now = self._clock()
        t0 = self._t_start.pop(rid, now)
        self.sketches["e2e_us"].add((now - t0) * 1e6)
        self.total_requests += 1
        self.requests.add(1.0, now=now)
        self.rec.end("decode", track=f"slot {slot}")
        self.rec.end(f"req {rid}", track=f"slot {slot}")
        self.rec.count("serve/requests_finished")
        if n_out:
            self.rec.count("serve/tokens_out", n_out)

    # -- export --------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Everything the bench / dashboard wants, as plain floats."""
        now = self._clock()
        return {
            "latency_us": {name: sk.quantiles()
                           for name, sk in self.sketches.items()
                           if sk.n},
            "tok_per_s_window": self.tokens.rate(now),
            "tok_per_s_ewma": self.tok_rate.value(now),
            "req_per_s_window": self.requests.rate(now),
            "total_tokens": self.total_tokens,
            "total_requests": self.total_requests,
            "steps": self._steps,
            "drift": (self.traffic.drift()
                      if self.traffic is not None else None),
            "traffic_events": (self.traffic.events
                               if self.traffic is not None else 0),
        }
