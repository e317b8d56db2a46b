"""Serving on the PyTorch/CUDA port: continuous batching over a bursty
request stream with live telemetry, and the MoE's live traffic
hypergraph partitioned by kahypar.

    PYTHONPATH=src python examples/serve_lm_torch.py [--cpu] [--out DIR]

Serves deepseek-v2's reduced config (8 experts) from random weights on
the GPU unless ``--cpu`` is given.  The gate tap feeds a
`TrafficAccumulator`; its snapshot is a hypergraph of expert
co-activations, which kahypar splits into 4 shards, beside the identity
placement.  A second burst then shows the traffic's drift from the
first.  Writes ``serve_trace.json`` into
``--out`` (a new temporary directory by default): open it in
https://ui.perfetto.dev for one row per batcher slot (request →
prefill/decode spans, per-token instants) beside the queue-depth,
tokens/s and drift counters.
"""
import argparse
import json
import os
import tempfile

import numpy as np

from repro_torch import obs
from repro_torch.configs.base import get_config
from repro_torch.core.hypergraph import connectivity, kahypar
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.serve.batching import serve_stream


def _burst(cfg, seed):
    """Bursty arrivals: (tick, prompt, max_new)."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 12)),
             rng.integers(1, cfg.vocab, rng.integers(2, 10)).tolist(), 6)
            for _ in range(9)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else "cuda"
    out = args.out or tempfile.mkdtemp(prefix="serve_lm_torch_")
    os.makedirs(out, exist_ok=True)

    cfg = get_config("deepseek_v2_236b").reduced()
    model = T.init_params(cfg, 0, device=dev)
    rec = obs.Recorder("serve")
    acc = obs.TrafficAccumulator(cfg.n_experts, decay=0.95)
    tele = obs.ServeTelemetry(recorder=rec, traffic=acc, advise_every=4)
    with moe.observe_gates(acc):
        reqs = serve_stream(model, cfg, _burst(cfg, 0), batch_slots=3,
                            max_len=64, telemetry=tele)
    for r in reqs:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")

    snap = tele.snapshot()
    lat = {k: {q: round(v, 1) for q, v in qs.items()}
           for k, qs in snap["latency_us"].items()}
    print(f"{snap['total_requests']} requests, {snap['total_tokens']} "
          f"tokens in {snap['steps']} decode steps")
    print(f"latency quantiles (us): {json.dumps(lat)}")
    print(f"throughput: {snap['tok_per_s_window']:.1f} tok/s (window), "
          f"{snap['tok_per_s_ewma']:.1f} tok/s (ewma)")

    # the live traffic hypergraph → an expert placement on 4 shards
    hg = acc.snapshot()
    hg.check()
    k = 4
    part = kahypar(hg, k, eps=0.1, preset="eco", seed=1, device=dev)
    identity = np.arange(hg.n) * k // hg.n
    print(f"traffic hypergraph: {hg.n} experts, {hg.m} nets from "
          f"{acc.events} routed tokens; kahypar (λ-1) "
          f"{connectivity(hg, part)} vs identity placement "
          f"{connectivity(hg, identity)}")
    acc.set_baseline()
    with moe.observe_gates(acc):
        serve_stream(model, cfg, _burst(cfg, 1), batch_slots=3, max_len=64)
    advised = acc.advise(rec)
    print(f"a second burst drifts {acc.drift():.3f} from the first "
          f"(repartition advised: {advised})")
    path = os.path.join(out, "serve_trace.json")
    n = obs.write_chrome_trace(rec, path, registry_gauges=True)
    print(f"wrote {path} ({n} events; open in https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
