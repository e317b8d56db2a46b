#!/usr/bin/env python3
"""The port's decoder stack across 4 cards: tensor and expert parallelism
over ``model``, data parallelism over ``data``.

    python3 tools/serve_torch_sharded.py [--out DIR]
    python3 tools/serve_torch_sharded.py --device cpu    # a CPU rehearsal

starts 4 ranks of itself, rank r on card r, joined through NCCL by a
``file://`` store under ``--out`` (as ``tests/torch_ranks.py`` joins its
ranks; no network), and runs, each model freed before the next:

``cut``   llama4-scout at full width, 2 layers, capacity factor 8 (nothing
          drops): the forward at B = 1, L = 2048 on the (data 1, model 4)
          mesh against rank 0's unsharded one-card forward, within 1e-4
          of max |logits|.
``llama4`` llama4-scout at full width, 24 of 48 layers (the 48 need 108
          GB per rank in f32), on (1, 4): a calibration forward of 510
          tokens (not a multiple of 4: the fallback, which reports to
          the gate tap), ``expert_placement`` of each layer's gates onto
          the 4 ranks (kaffpa on rank 0's card, handed to the others) and
          ``place_experts`` over the model axis; then the forward at B =
          2, L = 2048 (wall after a warm-up, peak memory per rank, the
          all-to-all / all-reduce / all-gather calls of one forward), and
          at capacity factor 8 a 64-token ``prefill_step`` and 16 greedy
          ``decode_step``s against the forward over the same tokens,
          within 2e-3 of max |logits|, ms per step beside the rank's
          weight-read bound.
``internvl2`` internvl2-26B whole (48 layers, ~19.9 GB per rank) on (1,
          4): the same forward with its 256 prefix embeddings and the same
          decode check (``prefill_step(prefix_embeds=)``).
``dp``    minicpm-2B whole: one card alone (rank 0, B = 1), then
          data-parallel on (data 4, model 1), each card B = 1 of a global
          batch of 4 x 2048 tokens, remat "full", AdamW/WSD: a warm-up
          and 3 timed steps each, tokens/s; the 4 replicas' parameters
          bit for bit equal after the steps (a MIN and a MAX over the
          ranks of every tensor).

Rank 0 prints what it measured, with each card's name and power limit;
the last line is one JSON object of every rank's results, also written to
``--out``/result.json.  Exits non-zero when a check fails or a rank dies.
With ``--device cpu`` the ranks join with gloo and run the ``reduced()``
configs at small shapes.  Imports nothing of jax or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WORLD = 4
TIMEOUT = 1500            # seconds, the whole run
COLLECTIVE_TIMEOUT = 180  # seconds, one collective
LLAMA, INTERNVL, MINICPM = ("llama4_scout_17b_a16e", "internvl2_26b",
                            "minicpm_2b")
# (the card's sizes, the CPU rehearsal's sizes)
SIZES = {
    "cuda": dict(depth=24, cut_depth=2, fwd=(2, 2048), cut_fwd=(1, 2048),
                 calib=510, prompt=64, steps=16, dp_seq=2048, dp_timed=3),
    "cpu": dict(depth=4, cut_depth=2, fwd=(2, 32), cut_fwd=(1, 32),
                calib=30, prompt=8, steps=4, dp_seq=32, dp_timed=2),
}
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


class Failed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def card_lines() -> list:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


class Rank:
    """One rank's run: its device, meshes, log and results."""

    def __init__(self, rank: int, dev: str, sizes: dict):
        import numpy as np
        import torch
        from repro_torch.core.mesh import Mesh
        self.np, self.torch, self.rank, self.sizes = np, torch, rank, sizes
        self.dev = torch.device(dev)
        self.cuda = self.dev.type == "cuda"
        self.tp = Mesh.world(("data", "model"), (1, WORLD), device=dev)
        self.dp = Mesh.world(("data", "model"), (WORLD, 1), device=dev)
        self.out = {}
        self.gen = torch.Generator(device=self.dev).manual_seed(7)

    def log(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, flush=True)

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def timed(self, fn):
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.empty_cache()
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return (int(self.torch.cuda.max_memory_allocated()) if self.cuda
                else 0)

    def config(self, arch: str, depth=None):
        from repro_torch.configs.base import get_config
        cfg = get_config(arch)
        if not self.cuda:
            cfg = cfg.reduced()
        return dataclasses.replace(cfg, n_layers=depth) if depth else cfg

    def tokens(self, cfg, *shape):
        return self.torch.randint(0, cfg.vocab, shape, generator=self.gen,
                                  device=self.dev)

    def check(self, cond: bool, msg: str) -> None:
        """``check`` on every rank at once: all raise if one fails, so no
        rank waits for another that has stopped."""
        check(self.dp.agree(cond), msg)

    def agree(self, x) -> bool:
        """True when ``x`` is bit for bit the same on every rank."""
        lo, hi = x.clone(), x.clone()
        self.dp.pmin(lo, "data")
        self.dp.pmax(hi, "data")
        return self.dp.agree(bool(self.torch.equal(lo, hi)))


def rel(torch, got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def counted(r: Rank, fn):
    """(fn(), the mesh collectives it issued on this rank)."""
    from repro_torch import obs
    from repro_torch.core.mesh import ALL_GATHER, ALL_REDUCE, ALL_TO_ALL
    names = (ALL_TO_ALL, ALL_REDUCE, ALL_GATHER)
    before = {n: obs.metrics.get(n) for n in names}
    out = fn()
    return out, {n.split("/")[1]: int(obs.metrics.get(n) - before[n])
                 for n in names}


def phase_cut(r: Rank) -> None:
    """2 layers at capacity factor 8: 4 ranks against one card."""
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    torch, s = r.torch, r.sizes
    cfg = dataclasses.replace(r.config(LLAMA, s["cut_depth"]),
                              capacity_factor=8.0)
    toks = r.tokens(cfg, *s["cut_fwd"])
    want = None
    if r.rank == 0:
        with torch.no_grad():
            model = T.init_params(cfg, 0, device=r.dev)
            want = T.forward(model, cfg, toks)[0]
        del model
    r.tp.agree(True)                 # rank 0's card is free again
    r.reset_peak()
    model = T.init_params(cfg, 0, mesh=r.tp)
    with torch.no_grad(), SH.use_mesh(r.tp):
        got = T.forward(model, cfg, toks)[0]
    err = 0.0
    if r.rank == 0:
        err = rel(torch, got, want)
        r.out["cut_rel"] = err
        r.log(f"{cfg.name} {cfg.n_layers} layers, capacity factor 8, B="
              f"{toks.shape[0]} L={toks.shape[1]}: 4 ranks (data 1, model 4) "
              f"vs one card: max |err| / max |logits| {err:g} (max 1e-4)")
    r.check(err <= 1e-4, f"the 4-rank forward differs from one card: {err}")


def decode_check(r: Rank, model, cfg, prefix=None) -> dict:
    """A prompt prefill and greedy decode steps at capacity factor 8
    against the forward over the same tokens; returns the figures."""
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import decode_step, prefill_step
    torch, s = r.torch, r.sizes
    cfg8 = dataclasses.replace(cfg, capacity_factor=8.0)
    b = 1 if prefix is None else prefix.shape[0]
    prompt = r.tokens(cfg, b, s["prompt"])
    n_pre = 0 if prefix is None else prefix.shape[1]
    with torch.no_grad(), SH.use_mesh(r.tp):
        caches = T.init_caches(cfg8, b, n_pre + s["prompt"] + s["steps"],
                               device=r.dev, mesh=r.tp)
        lg, _ = prefill_step(model, cfg8, prompt, caches,
                             prefix_embeds=prefix)
        got, fed, walls = [lg], [], []
        for i in range(s["steps"]):
            tok = lg.argmax(-1)[:, None]
            (lg, _), wall = r.timed(lambda: decode_step(
                model, cfg8, tok, caches, n_pre + s["prompt"] + i))
            got.append(lg)
            fed.append(tok)
            walls.append(wall)
        seq = torch.cat([prompt] + fed, 1)
        want = T.forward(model, cfg8, seq, prefix_embeds=prefix)[0][
            :, n_pre + s["prompt"] - 1:]
    err = rel(torch, torch.stack(got, 1), want)
    weight = sum(p.numel() * p.element_size() for p in model.parameters())
    walls.sort()
    res = {"decode_rel": err, "decode_ms_median": walls[len(walls) // 2] * 1e3,
           "decode_ms_min": walls[0] * 1e3,
           "decode_bound_ms": weight / PEAK_BYTES_PER_S * 1e3}
    r.log(f"{cfg.name} decode on 4 ranks: prefill of {s['prompt']} tokens"
          f"{'' if prefix is None else f' after {n_pre} prefix embeddings'}"
          f" + {s['steps']} greedy steps vs the forward at capacity factor "
          f"8: rel {err:g} (max 2e-3); ms per step median "
          f"{res['decode_ms_median']:.3f} (min {res['decode_ms_min']:.3f}) "
          f"against the rank's weight-read bound "
          f"{res['decode_bound_ms']:.3f} ms")
    r.check(err <= 2e-3, f"{cfg.name}: decode differs from the forward: "
            f"{err}")
    return res


def forward_figures(r: Rank, model, cfg, prefix=None) -> dict:
    """The timed forward at ``fwd`` (after a warm-up): wall, peak memory
    per rank, the collectives of one forward."""
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    torch, s = r.torch, r.sizes
    b, l = s["fwd"]
    toks = r.tokens(cfg, b, l)
    with torch.no_grad(), SH.use_mesh(r.tp):
        T.forward(model, cfg, toks, prefix_embeds=prefix)
        r.reset_peak()
        (logits, calls), wall = r.timed(lambda: counted(
            r, lambda: T.forward(model, cfg, toks, prefix_embeds=prefix)[0]))
    n_tok = b * (l + (0 if prefix is None else prefix.shape[1]))
    r.check(logits.shape == (b, n_tok // b, cfg.vocab_pad)
            and bool(torch.isfinite(logits).all()),
            f"{cfg.name}: logits of shape {tuple(logits.shape)}, finite "
            f"{bool(torch.isfinite(logits).all())}")
    weight = sum(p.numel() * p.element_size() for p in model.parameters())
    res = {"forward_s": wall, "tokens_per_s": n_tok / wall,
           "peak_bytes": r.peak(), "param_bytes": weight, "calls": calls}
    r.log(f"{cfg.name} ({cfg.n_layers} layers) forward B={b} L={l}"
          f"{'' if prefix is None else f' + {prefix.shape[1]} prefix'} on 4 "
          f"ranks (data 1, model 4): wall_s={wall:.4f} "
          f"({n_tok / wall:.1f} tokens/s), rank 0's parameters {weight} B "
          f"({weight / 1e9:.2f} GB), peak {res['peak_bytes']} B "
          f"({res['peak_bytes'] / 2**30:.2f} GiB), collectives of one "
          f"forward {json.dumps(calls)}")
    return res


def phase_llama4(r: Rank) -> None:
    from repro_torch.models import moe as MOE
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    torch, s = r.torch, r.sizes
    cfg = r.config(LLAMA, s["depth"])
    r.reset_peak()
    model, secs = r.timed(lambda: T.init_params(cfg, 0, mesh=r.tp))
    r.log(f"{cfg.name}: {cfg.n_layers} of 48 layers made sharded over "
          f"model=4 from seed 0 in {secs:.3f} s (peak while drawing "
          f"{r.peak() / 2**30:.2f} GiB)")
    # calibration: a length the model axis does not divide takes the
    # fallback, which reports each layer's routing to the gate tap
    gates = []
    with torch.no_grad(), SH.use_mesh(r.tp), MOE.observe_gates(gates.append):
        T.forward(model, cfg, r.tokens(cfg, 1, s["calib"]))
    r.check(len(gates) == cfg.n_layers, f"gate tap: {len(gates)} reports")
    # rank 0 places (kaffpa on its card); a sum over the ranks hands its
    # permutations to the others
    perms = torch.zeros(cfg.n_layers, cfg.n_experts, dtype=torch.int64,
                        device=r.dev)
    wall = 0.0
    if r.rank == 0:
        placed, wall = r.timed(lambda: [MOE.expert_placement(
            g, cfg.n_experts, WORLD, seed=1, device=r.dev) for g in gates])
        perms.copy_(torch.as_tensor(r.np.stack(placed)))
    perms = r.dp.psum(perms, "data").cpu().numpy()
    r.check(all(sorted(p) == list(range(cfg.n_experts)) for p in perms),
            "an expert placement is not a permutation")
    e_loc, loads = cfg.n_experts // WORLD, []
    for blk, g, perm in zip(model.blocks, gates, perms):
        blk.moe = MOE.place_experts(blk.moe, perm, r.tp)
        loads.append([int(r.np.isin(g, perm[j * e_loc:(j + 1) * e_loc]).sum())
                      for j in range(WORLD)])
    r.log(f"expert placement of {cfg.n_layers} layers' gates ({s['calib']} "
          f"calibration tokens) onto 4 ranks on rank 0's card: {wall:.3f} s "
          f"(kaffpa, lp_affinity on the card); per-rank loads "
          f"of layer 0 {loads[0]}, max over layers of the largest rank load "
          f"{max(max(x) for x in loads)} (even: {s['calib'] / WORLD:g})")
    res = forward_figures(r, model, cfg)
    res.update(decode_check(r, model, cfg))
    res["placement_s"] = wall
    r.out["llama4"] = res


def phase_internvl2(r: Rank) -> None:
    from repro_torch.models import transformer as T
    torch, s = r.torch, r.sizes
    cfg = r.config(INTERNVL)
    r.reset_peak()
    model, secs = r.timed(lambda: T.init_params(cfg, 0, mesh=r.tp))
    r.log(f"{cfg.name}: all {cfg.n_layers} layers made sharded over model=4 "
          f"from seed 0 in {secs:.3f} s")

    def prefix(b):
        return torch.randn(b, cfg.n_prefix_embeds, cfg.d_model,
                           generator=r.gen, device=r.dev) * 0.1

    res = forward_figures(r, model, cfg, prefix(s["fwd"][0]))
    res.update(decode_check(r, model, cfg, prefix(1)))
    r.out["internvl2"] = res


def train_run(r: Rank, cfg, mesh, shard: int, n_shards: int) -> dict:
    """A warm-up and timed steps of minicpm at B = 1 per card."""
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.train.data import DataConfig, batches
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_opt_state, make_train_step
    s = r.sizes
    r.reset_peak()
    model = T.init_params(cfg, 0, device=r.dev)
    opt = init_opt_state(model)
    step = make_train_step(cfg, OptConfig(), remat="full")
    data = batches(DataConfig(cfg.vocab, s["dp_seq"], n_shards), shard=shard,
                   n_shards=n_shards, device=r.dev)
    walls, losses = [], []
    with (SH.use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        for i in range(1 + s["dp_timed"]):
            batch = next(data)
            (_, _, m), wall = r.timed(lambda: step(model, opt, batch))
            losses.append(float(m["loss"]))
            if i:
                walls.append(wall)
    walls.sort()
    med = walls[len(walls) // 2]
    return {"model": model, "step_s": med, "tokens_per_s":
            n_shards * s["dp_seq"] / med, "losses": losses,
            "peak_bytes": r.peak()}


def phase_dp(r: Rank) -> None:
    cfg = r.config(MINICPM)
    one = None
    if r.rank == 0:
        one = train_run(r, cfg, None, 0, 1)
        del one["model"]
        r.log(f"{cfg.name} train step on one card, B=1 S={r.sizes['dp_seq']}"
              f" (remat full, AdamW/WSD, f32): {one['step_s']:.4f} s, "
              f"{one['tokens_per_s']:.1f} tokens/s, peak "
              f"{one['peak_bytes'] / 2**30:.2f} GiB")
    r.check(one is None or all(math.isfinite(x) for x in one["losses"]),
            f"non-finite one-card losses {one and one['losses']}")
    dp = train_run(r, cfg, r.dp, r.rank, WORLD)
    r.check(all(math.isfinite(x) for x in dp["losses"]),
            f"non-finite data-parallel losses {dp['losses']}")
    same = all(r.agree(p.detach()) for p in dp.pop("model").parameters())
    r.out["dp"] = {"one_card": one, "four_cards": dp, "replicas_equal": same}
    if r.rank == 0:
        r.log(f"{cfg.name} data-parallel on (data 4, model 1), each card B=1 "
              f"S={r.sizes['dp_seq']}: {dp['step_s']:.4f} s per step, "
              f"{dp['tokens_per_s']:.1f} tokens/s ({dp['tokens_per_s'] / one['tokens_per_s']:.3f}x "
              f"one card's), losses {[round(x, 4) for x in dp['losses']]}, "
              f"peak {dp['peak_bytes'] / 2**30:.2f} GiB; the 4 replicas' "
              f"parameters bit for bit equal: {same}")
    r.check(same, "the data-parallel replicas' parameters differ")


def run_rank(rank: int, store: str, dev: str, out: Path) -> int:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.ranks import join
    dev = join(rank, WORLD, store, dev, timeout=COLLECTIVE_TIMEOUT)
    torch.backends.cuda.matmul.allow_tf32 = False
    r = Rank(rank, dev, SIZES["cpu" if dev == "cpu" else "cuda"])
    try:
        for phase in (phase_cut, phase_llama4, phase_internvl2, phase_dp):
            phase(r)
            if r.cuda:
                torch.cuda.empty_cache()
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(r.out))
        dist.destroy_process_group()
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                          "serve_torch_sharded"))
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if args.rank is not None:
        return run_rank(args.rank, args.store, args.device, out)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
            print(f"error: needs {WORLD} CUDA devices", file=sys.stderr)
            return 2
        cards = card_lines()
        print(f"cards: {cards}", flush=True)
    from repro_torch.launch.ranks import rank_env, spawn
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob("rank*.json"):
        f.unlink()
    t0 = time.perf_counter()
    store = out / "store"
    codes = spawn(lambda r: [__file__, "--device", args.device, "--out",
                             str(out), "--rank", str(r), "--store",
                             str(store)],
                  WORLD, [out / f"rank{r}.log" for r in range(WORLD)],
                  TIMEOUT, store, env=rank_env(ROOT / "src"), echo=0)
    for r, code in enumerate(codes):
        if code and r:
            text = (out / f"rank{r}.log").read_text()
            print(f"rank {r} exited {code}:\n{text[-4000:]}", file=sys.stderr)
    ranks = [json.loads(f.read_text()) if f.exists() else None
             for f in (out / f"rank{r}.json" for r in range(WORLD))]
    result = {"ok": not any(codes), "codes": codes, "wall_s":
              time.perf_counter() - t0, "ranks": ranks}
    if args.device == "cuda":
        result["cards"] = cards
    (out / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Failed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
