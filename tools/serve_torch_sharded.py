#!/usr/bin/env python3
"""The port's decoder stack across 4 cards: tensor and expert parallelism
over ``model``; data parallelism, FSDP (ZeRO-3) and context parallelism
over ``data``.

    python3 tools/serve_torch_sharded.py [--out DIR] [--modes M,M,...]
    python3 tools/serve_torch_sharded.py --device cpu    # a CPU rehearsal

starts 4 ranks of itself, rank r on card r, joined through NCCL by a
``file://`` store under ``--out`` (as ``tests/torch_ranks.py`` joins its
ranks; no network), and runs the ``--modes`` (default: all, in the order
below), each model freed before the next:

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
          batch of 4 x 2048 tokens and 1/4 of every sharded leaf (FSDP),
          remat "full", AdamW/WSD: a warm-up and 3 timed steps each,
          tokens/s; the leaves FSDP leaves whole bit for bit equal on the
          4 cards after the steps (a MIN and a MAX over the ranks).
``deepseek_cut`` deepseek-v2 at full width, 2 layers, capacity factor 8,
          as ``cut`` (B = 1, L = 2048).
``deepseek`` deepseek-v2 at full width (MLA with 128 heads, 160 experts of
          1536, top-6, 2 shared) on (1, 4), as many of its 60 layers as
          leave 15 GB of each card free (`launch.dryrun.fitting_depth`:
          the per-rank bytes of 1 and 2 layers under ``FakeTensorMode``): as
          ``llama4`` (the placement of 160 experts onto the 4 ranks runs
          kernel 1, its launches counted), the forward at B = 1, L = 2048.
``zamba2``, ``rwkv6``, ``whisper`` each model whole at full width on
          (1, 4): the forward (B = 2, L = 2048; whisper on 1500 frames
          and 448 tokens) against rank 0's one-card forward within 1e-4
          of max |logits|, the forward's figures, and a 64-token prefill
          (token by token for zamba2 and rwkv6, with the frames for
          whisper) + 16 greedy decode steps against the forward within
          2e-3.  zamba2 also counts its SSD calls (54 grouped calls of
          heads = 20 on each rank) and holds layer 0's per-rank scan
          against ``ref.ssd_scan_grouped_ref`` within 3e-4 (abs + rel,
          the tolerance of tests/test_kernels.py).
``gemma2_cut`` gemma2-9B at full width, 2 layers: 3 steps of 2 x 4096
          tokens on (data 2, model 2), parameters sharded over both axes,
          against rank 0's one card (the same batches as 2 microbatches),
          within 1e-5 of max |p| (AdamW at eps 1e-3).
``gemma2_train`` gemma2-9B whole (42 layers, 9.24 B parameters: 147.86 GB
          of f32 parameters, gradients and moments, 36.96 GB per rank) on
          (2, 2): a warm-up and 3 timed steps of 2 x 4096 tokens (one row
          per data rank), remat "full", AdamW/WSD, from seed 0: ms per
          step, tokens/s, FLOP/s (8·N·T), peak memory per rank, the
          all-gathers, reduce-scatters and all-reduces per step.
``zamba2_cp_cut`` zamba2-2.7B whole at B = 1, max_len 32768: caches filled
          from seeded draws (`fill_zamba2`) to 32752, then 16 decode steps
          on (2, 2), the KV caches' sequence split over data, against
          rank 0's one card from the same draws, within 1e-4 of max
          |logits|.
``zamba2_long`` the same at max_len 524288 (``SHAPES["long_500k"]``):
          24.16 GB of ``attn.k/v`` per rank; ms per step against the
          read bound, cache bytes, peak memory, collectives per step.

Rank 0 prints what it measured, with each card's name and power limit;
the last line is one JSON object of every rank's results, also written to
``--out``/result.json.  Exits non-zero when a check fails or a rank dies.
With ``--device cpu`` the ranks join with gloo and run the ``reduced()``
configs at small shapes (rwkv6's widened to d_model 128: its 2 heads do
not split over 4 ranks; gemma2 on 32 tokens a row, zamba2 at max_len 64
and 128).  Imports nothing of jax or of the JAX package.
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
DEEPSEEK, ZAMBA2, RWKV6, WHISPER = ("deepseek_v2_236b", "zamba2_2p7b",
                                    "rwkv6_7b", "whisper_medium")
GEMMA2 = "gemma2_9b"
# (the card's sizes, the CPU rehearsal's sizes); ``dec_tokens``: whisper's
# decoder tokens beside its encoder frames
# ``train_seq``: gemma2's tokens per row (``SHAPES["train_4k"]``);
# ``long_len``/``cut_len``: zamba2's max_len (``SHAPES["long_500k"]``) and
# its one-card cut; ``fill_chunk``: the positions of one seeded cache draw
SIZES = {
    "cuda": dict(depth=24, cut_depth=2, fwd=(2, 2048), cut_fwd=(1, 2048),
                 calib=510, prompt=64, steps=16, dp_seq=2048, dp_timed=3,
                 ds_fwd=(1, 2048), dec_tokens=448, train_seq=4096,
                 train_timed=3, long_len=524288, cut_len=32768,
                 fill_chunk=4096),
    "cpu": dict(depth=4, cut_depth=2, fwd=(2, 32), cut_fwd=(1, 32),
                calib=30, prompt=8, steps=4, dp_seq=32, dp_timed=2,
                ds_fwd=(1, 32), dec_tokens=16, train_seq=32, train_timed=2,
                long_len=128, cut_len=64, fill_chunk=16),
}
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
SSD_TOL = 3e-4                 # tests/test_kernels.py's abs + rel


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
        self.both = Mesh.world(("data", "model"), (2, 2), device=dev)
        self.out = {}
        self.gen = torch.Generator(device=self.dev).manual_seed(7)
        #: the cards' names and power limits, on rank 0 of a CUDA run
        self.card = "; ".join(card_lines()) if self.cuda and rank == 0 \
            else "cpu"

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
            if arch == RWKV6:
                cfg = dataclasses.replace(cfg, d_model=128)
        return dataclasses.replace(cfg, n_layers=depth) if depth else cfg

    def peaks(self) -> list:
        """Every rank's peak memory, in rank order."""
        mine = self.torch.tensor([self.peak()], device=self.dev)
        return self.dp.all_gather(mine).tolist()

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
    """(fn(), the mesh collectives and SSD scan calls it issued on this
    rank)."""
    from repro_torch import obs
    from repro_torch.core.mesh import (ALL_GATHER, ALL_REDUCE, ALL_TO_ALL,
                                       REDUCE_SCATTER)
    from repro_torch.kernels.ssd_scan import LAUNCHES
    names = (ALL_TO_ALL, ALL_REDUCE, ALL_GATHER, REDUCE_SCATTER, LAUNCHES)
    before = {n: obs.metrics.get(n) for n in names}
    out = fn()
    return out, {n.split("/")[1]: int(obs.metrics.get(n) - before[n])
                 for n in names}


def against_one_card(r: Rank, cfg, toks, frames=None):
    """The forward on (data 1, model 4) of the model made sharded from
    seed 0 against rank 0's unsharded one-card forward from the same seed,
    within 1e-4 of max |logits|; returns the sharded model."""
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    torch = r.torch
    want = None
    if r.rank == 0:
        with torch.no_grad():
            model = T.init_params(cfg, 0, device=r.dev)
            want = T.forward(model, cfg, toks, enc_frames=frames)[0]
        del model
    r.tp.agree(True)                 # rank 0's card is free again
    r.reset_peak()
    model = T.init_params(cfg, 0, mesh=r.tp)
    with torch.no_grad(), SH.use_mesh(r.tp):
        got = T.forward(model, cfg, toks, enc_frames=frames)[0]
    err = 0.0
    if r.rank == 0:
        err = rel(torch, got, want)
        cf = (f", capacity factor {cfg.capacity_factor:g}" if cfg.is_moe
              else "")
        r.log(f"{cfg.name} {cfg.n_layers} layers{cf}, B={toks.shape[0]} "
              f"L={toks.shape[1]}"
              f"{'' if frames is None else f' + {frames.shape[1]} frames'}:"
              f" 4 ranks (data 1, model 4) vs one card: max |err| / max "
              f"|logits| {err:g} (max 1e-4) [{r.card}]")
    r.check(err <= 1e-4, f"{cfg.name}: the 4-rank forward differs from one "
            f"card: {err}")
    return model, err


def phase_cut(r: Rank, arch: str = LLAMA, key: str = "cut_rel") -> None:
    """``arch`` (a MoE), 2 layers at capacity factor 8: 4 ranks against
    one card."""
    s = r.sizes
    cfg = dataclasses.replace(r.config(arch, s["cut_depth"]),
                              capacity_factor=8.0)
    _, r.out[key] = against_one_card(r, cfg, r.tokens(cfg, *s["cut_fwd"]))


def decode_check(r: Rank, model, cfg, prefix=None, frames=None) -> dict:
    """A prompt prefill (with the vlm's prefix or the audio's frames) and
    greedy decode steps at capacity factor 8 against the forward over the
    same tokens; returns the figures."""
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import decode_step, prefill_step
    torch, s = r.torch, r.sizes
    cfg8 = dataclasses.replace(cfg, capacity_factor=8.0)
    b = next((a.shape[0] for a in (prefix, frames) if a is not None), 1)
    prompt = r.tokens(cfg, b, s["prompt"])
    n_pre = 0 if prefix is None else prefix.shape[1]
    with torch.no_grad(), SH.use_mesh(r.tp):
        caches = T.init_caches(cfg8, b, n_pre + s["prompt"] + s["steps"],
                               device=r.dev, mesh=r.tp,
                               enc_len=None if frames is None
                               else frames.shape[1])
        lg, _ = prefill_step(model, cfg8, prompt, caches,
                             prefix_embeds=prefix, enc_frames=frames)
        got, fed, walls = [lg], [], []
        for i in range(s["steps"]):
            tok = lg.argmax(-1)[:, None]
            (lg, _), wall = r.timed(lambda: decode_step(
                model, cfg8, tok, caches, n_pre + s["prompt"] + i))
            got.append(lg)
            fed.append(tok)
            walls.append(wall)
        seq = torch.cat([prompt] + fed, 1)
        want = T.forward(model, cfg8, seq, prefix_embeds=prefix,
                         enc_frames=frames)[0][:, n_pre + s["prompt"] - 1:]
    err = rel(torch, torch.stack(got, 1), want)
    weight = sum(p.numel() * p.element_size() for p in model.parameters())
    walls.sort()
    res = {"decode_rel": err, "decode_ms_median": walls[len(walls) // 2] * 1e3,
           "decode_ms_min": walls[0] * 1e3,
           "decode_bound_ms": weight / PEAK_BYTES_PER_S * 1e3}
    how = ("" if prefix is None else f" after {n_pre} prefix embeddings"
           ) + ("" if frames is None else f" with {frames.shape[1]} frames")
    r.log(f"{cfg.name} decode on 4 ranks: prefill of {s['prompt']} tokens"
          f"{how}{' token by token' if cfg.family in ('hybrid', 'ssm') else ''}"
          f" + {s['steps']} greedy steps vs the forward at capacity factor "
          f"8: rel {err:g} (max 2e-3); ms per step median "
          f"{res['decode_ms_median']:.3f} (min {res['decode_ms_min']:.3f}) "
          f"against the rank's weight-read bound "
          f"{res['decode_bound_ms']:.3f} ms [{r.card}]")
    r.check(err <= 2e-3, f"{cfg.name}: decode differs from the forward: "
            f"{err}")
    return res


def forward_figures(r: Rank, model, cfg, prefix=None, frames=None,
                    shape=None) -> dict:
    """The timed forward at ``shape`` (default ``fwd``; after a warm-up):
    wall, every rank's peak memory, the collectives and SSD calls of one
    forward."""
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    torch, s = r.torch, r.sizes
    b, l = shape or s["fwd"]
    toks = r.tokens(cfg, b, l)
    kw = {"prefix_embeds": prefix, "enc_frames": frames}
    with torch.no_grad(), SH.use_mesh(r.tp):
        T.forward(model, cfg, toks, **kw)
        r.reset_peak()
        (logits, calls), wall = r.timed(lambda: counted(
            r, lambda: T.forward(model, cfg, toks, **kw)[0]))
    n_tok = b * (l + (0 if prefix is None else prefix.shape[1]))
    r.check(logits.shape == (b, n_tok // b, cfg.vocab_pad)
            and bool(torch.isfinite(logits).all()),
            f"{cfg.name}: logits of shape {tuple(logits.shape)}, finite "
            f"{bool(torch.isfinite(logits).all())}")
    weight = sum(p.numel() * p.element_size() for p in model.parameters())
    peaks = r.peaks()
    res = {"forward_s": wall, "tokens_per_s": n_tok / wall,
           "peak_bytes": peaks[r.rank], "peak_bytes_by_rank": peaks,
           "param_bytes": weight, "calls": calls}
    what = ("" if prefix is None else f" + {prefix.shape[1]} prefix") + (
        "" if frames is None else f" on {frames.shape[1]} frames")
    r.log(f"{cfg.name} ({cfg.n_layers} layers) forward B={b} L={l}{what} on "
          f"4 ranks (data 1, model 4): wall_s={wall:.4f} "
          f"({n_tok / wall:.1f} tokens/s), rank 0's parameters {weight} B "
          f"({weight / 1e9:.2f} GB), peak per rank {peaks} B "
          f"({[round(p / 2**30, 2) for p in peaks]} GiB), collectives and "
          f"SSD calls of one forward {json.dumps(calls)} [{r.card}]")
    return res


def placed(r: Rank, model, cfg) -> dict:
    """The calibration forward (a length the model axis does not divide
    takes the fallback, which reports each layer's routing to the gate
    tap), ``expert_placement`` of each layer's gates onto the 4 ranks on
    rank 0's card (kaffpa; lp_affinity's launches counted from 0), handed
    to the other ranks by a sum, and ``place_experts`` over the model
    axis; returns the figures."""
    from repro_torch import obs
    from repro_torch.kernels.lp_affinity import LAUNCHES
    from repro_torch.models import moe as MOE
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    torch, s = r.torch, r.sizes
    gates = []
    with torch.no_grad(), SH.use_mesh(r.tp), MOE.observe_gates(gates.append):
        T.forward(model, cfg, r.tokens(cfg, 1, s["calib"]))
    r.check(len(gates) == cfg.n_layers, f"gate tap: {len(gates)} reports")
    perms = torch.zeros(cfg.n_layers, cfg.n_experts, dtype=torch.int64,
                        device=r.dev)
    wall, launches = 0.0, 0
    if r.rank == 0:
        obs.metrics.reset(LAUNCHES)
        found, wall = r.timed(lambda: [MOE.expert_placement(
            g, cfg.n_experts, WORLD, seed=1, device=r.dev) for g in gates])
        launches = int(obs.metrics.get(LAUNCHES))
        perms.copy_(torch.as_tensor(r.np.stack(found)))
    perms = r.dp.psum(perms, "data").cpu().numpy()
    r.check(all(sorted(p) == list(range(cfg.n_experts)) for p in perms),
            "an expert placement is not a permutation")
    r.check(not r.cuda or r.rank != 0 or launches > 0,
            "expert placement launched no lp_affinity kernel")
    e_loc, loads = cfg.n_experts // WORLD, []
    for blk, g, perm in zip(model.blocks, gates, perms):
        blk.moe = MOE.place_experts(blk.moe, perm, r.tp)
        loads.append([int(r.np.isin(g, perm[j * e_loc:(j + 1) * e_loc]).sum())
                      for j in range(WORLD)])
    pairs = s["calib"] * cfg.top_k
    r.log(f"expert placement of {cfg.n_layers} layers' gates ({s['calib']} "
          f"calibration tokens, top-{cfg.top_k}) of {cfg.n_experts} experts "
          f"onto 4 ranks on rank 0's card: {wall:.3f} s (kaffpa, "
          f"{launches} lp_affinity launches on the card); per-rank loads "
          f"of layer 0 {loads[0]}, max over layers of the largest rank load "
          f"{max(max(x) for x in loads)} (even: {pairs / WORLD:g}) "
          f"[{r.card}]")
    return {"placement_s": wall, "lp_affinity_launches": launches}


def phase_llama4(r: Rank) -> None:
    from repro_torch.models import transformer as T
    s = r.sizes
    cfg = r.config(LLAMA, s["depth"])
    r.reset_peak()
    model, secs = r.timed(lambda: T.init_params(cfg, 0, mesh=r.tp))
    r.log(f"{cfg.name}: {cfg.n_layers} of 48 layers made sharded over "
          f"model=4 from seed 0 in {secs:.3f} s (peak while drawing "
          f"{r.peak() / 2**30:.2f} GiB)")
    fig = placed(r, model, cfg)
    res = forward_figures(r, model, cfg)
    res.update(decode_check(r, model, cfg))
    res.update(fig)
    r.out["llama4"] = res


def phase_deepseek(r: Rank) -> None:
    from repro_torch.launch.dryrun import fitting_depth, rank_bytes
    from repro_torch.models import transformer as T
    s = r.sizes
    total = (r.torch.cuda.get_device_properties(r.dev).total_memory
             if r.cuda else 0)
    full = r.config(DEEPSEEK)
    depth = fitting_depth(full, r.tp, total) if r.cuda else s["depth"]
    nbytes = rank_bytes(full, depth, r.tp)
    cfg = r.config(DEEPSEEK, depth)
    r.check(depth > 2, f"{cfg.name}: only {depth} layers fit")
    r.reset_peak()
    model, secs = r.timed(lambda: T.init_params(cfg, 0, mesh=r.tp))
    weight = sum(p.numel() * p.element_size() for p in model.parameters())
    r.check(weight == nbytes, f"{cfg.name}: {weight} B of parameters, "
            f"sized {nbytes}")
    r.log(f"{cfg.name}: {depth} of 60 layers ({nbytes} B = "
          f"{nbytes / 1e9:.2f} GB per rank, leaving "
          f"{(total - nbytes) / 1e9:.2f} GB of the card's {total} B) made "
          f"sharded over model=4 from seed 0 in {secs:.3f} s (peak while "
          f"drawing {r.peak() / 2**30:.2f} GiB) [{r.card}]")
    fig = placed(r, model, cfg)
    res = forward_figures(r, model, cfg, shape=s["ds_fwd"])
    res.update(decode_check(r, model, cfg))
    res.update(fig, depth=depth)
    r.out["deepseek"] = res


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


def ssd_rank_check(r: Rank, model, cfg, toks) -> dict:
    """Layer 0's per-rank scan (its nheads/4 heads sharing one row of B
    and C) on the forward's real inputs: ``ops.ssd_scan`` against
    ``ref.ssd_scan_grouped_ref`` within `SSD_TOL` abs + rel."""
    import math
    from repro_torch.kernels import ops, ref
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rmsnorm
    torch = r.torch
    blk = model.blocks[0]
    nh = M2.heads(blk.mamba)
    with torch.no_grad(), SH.use_mesh(r.tp):
        x0 = T._embed(model.embed, toks, WORLD) * math.sqrt(cfg.d_model)
        _, _, x_eff, ld, bmat, cmat, _ = M2.scan_inputs(
            blk.mamba, rmsnorm(x0, blk.ln1, cfg.norm_eps), cfg)
    ins = M2.merge_heads(x_eff, ld, bmat, cmat)
    got = ops.ssd_scan(*ins, heads=nh)
    want = ref.ssd_scan_grouped_ref(*ins, nh)
    excess = float(((got - want).abs() - SSD_TOL * want.abs()).max())
    err = float((got - want).abs().max())
    r.log(f"ssd_scan on rank 0's layer-0 inputs {tuple(ins[0].shape)} "
          f"heads={nh}: max |err| {err:g} against ssd_scan_grouped_ref, "
          f"|err| - {SSD_TOL}|want| at most {excess:g} (max {SSD_TOL}) "
          f"[{r.card}]")
    r.check(excess <= SSD_TOL, f"the per-rank SSD scan disagrees: {excess}")
    return {"ssd_heads": nh, "ssd_max_abs_err": err}


def family_mode(r: Rank, arch: str) -> None:
    """One model whole at full width on (1, 4): against one card, the
    forward's figures, decode against the forward; zamba2's SSD calls
    and its per-rank scan."""
    from repro_torch.kernels import ops
    torch, s = r.torch, r.sizes
    cfg = r.config(arch)
    b, l = s["fwd"]
    frames = None
    if cfg.enc_layers:
        l = s["dec_tokens"]
        frames = torch.randn(b, cfg.enc_positions, cfg.d_model,
                             generator=r.gen, device=r.dev)
    toks = r.tokens(cfg, b, l)
    model, err = against_one_card(r, cfg, toks, frames)
    heads, real = [], ops.ssd_scan

    def recording(*args, **kw):
        heads.append(kw.get("heads"))
        return real(*args, **kw)

    ops.ssd_scan = recording
    try:
        res = forward_figures(r, model, cfg, frames=frames, shape=(b, l))
    finally:
        ops.ssd_scan = real
    res["one_card_rel"] = err
    if cfg.family == "hybrid":
        # the kernel engine on a card, the chunked torch engine on the
        # CPU; ``heads`` holds the warm-up's calls and the timed forward's
        nh, calls = cfg.ssm_nheads // WORLD, cfg.n_layers if r.cuda else 0
        r.log(f"{cfg.name}: {len(heads) // 2} ssd_scan calls per forward on "
              f"rank 0, heads {sorted(set(heads))} (expected {calls} of "
              f"heads={nh}), {res['calls']['ssd_scan']} counted launches in "
              f"the timed forward")
        r.check(heads == [nh] * 2 * calls
                and res["calls"]["ssd_scan"] == calls,
                f"{cfg.name}: ssd_scan calls {heads}, launches "
                f"{res['calls']['ssd_scan']}")
        res.update(ssd_rank_check(r, model, cfg, toks))
    res.update(decode_check(r, model, cfg, frames=None if frames is None
                            else frames[:1]))
    r.out[arch] = res


def train_run(r: Rank, cfg, mesh, shard: int, n_shards: int) -> dict:
    """A warm-up and timed steps of minicpm at B = 1 per card (on a mesh,
    each card holding its FSDP shards)."""
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.train.data import DataConfig, batches
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_opt_state, make_train_step
    s = r.sizes
    r.reset_peak()
    model = T.init_params(cfg, 0, device=r.dev, mesh=mesh)
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
    # the leaves the data axis does not shard are replicas
    same = all(r.agree(p.detach()) for p in dp.pop("model").parameters()
               if p.fsdp_dim is None)
    r.out["dp"] = {"one_card": one, "four_cards": dp, "replicas_equal": same}
    if r.rank == 0:
        r.log(f"{cfg.name} data-parallel on (data 4, model 1), each card B=1 "
              f"S={r.sizes['dp_seq']}: {dp['step_s']:.4f} s per step, "
              f"{dp['tokens_per_s']:.1f} tokens/s ({dp['tokens_per_s'] / one['tokens_per_s']:.3f}x "
              f"one card's), losses {[round(x, 4) for x in dp['losses']]}, "
              f"peak {dp['peak_bytes'] / 2**30:.2f} GiB (FSDP: each card "
              f"1/4 of every sharded leaf); the unsharded leaves bit for "
              f"bit equal on the 4 cards: {same}")
    r.check(same, "the data-parallel replicas' parameters differ")


# -- the data axis on (data 2, model 2): FSDP training, long-context decode -----

def whole_rel(r: Rank, model, want: dict) -> float:
    """The largest over ``model``'s parameters (held as blocks of its
    mesh, reassembled whole on every rank) of max |p − want| / max
    |want|, on rank 0, where ``want`` holds the one-card parameters."""
    from repro_torch.models import shardings as SH
    worst = 0.0
    for name, p in model.named_parameters():
        whole = SH.whole_leaf(name, p.detach(), model.cfg, model.mesh)
        if r.rank == 0:
            worst = max(worst, rel(r.torch, whole, want[name]))
        del whole
    return worst


def gemma2_batches(r: Rank, cfg, n: int) -> list:
    """``n`` seeded global batches of 2 rows of ``train_seq`` + 1 tokens
    (``SHAPES["train_4k"]``'s length), the same on every rank."""
    gen = r.torch.Generator(device=r.dev).manual_seed(57)
    return [r.torch.randint(0, cfg.vocab, (2, r.sizes["train_seq"] + 1),
                            generator=gen, device=r.dev) for _ in range(n)]


def train_steps(r: Rank, cfg, model, mesh, batches, opt_cfg,
                microbatches: int = 1) -> dict:
    """One step per batch (each data rank its row of it) with remat
    "full" and AdamW; the first is a warm-up.  Returns the walls, losses
    and, per timed step, the collectives."""
    from repro_torch.models import shardings as SH
    from repro_torch.train.train_step import init_opt_state, make_train_step
    opt = init_opt_state(model)
    step = make_train_step(cfg, opt_cfg, remat="full",
                           microbatches=microbatches)
    i, n = (0, 1) if mesh is None else SH.block_index("data", mesh)
    walls, losses, calls = [], [], []
    with (SH.use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        for k, batch in enumerate(batches):
            rows = batch[i * 2 // n:(i + 1) * 2 // n]
            ((_, _, m), c), wall = r.timed(lambda: counted(
                r, lambda: step(model, opt, {"tokens": rows})))
            losses.append(float(m["loss"]))
            if k:
                walls.append(wall)
                calls.append(c)
    for p in model.parameters():
        p.grad = None
    del opt
    return {"walls": walls, "losses": losses, "calls": calls}


def phase_gemma2_cut(r: Rank) -> None:
    """gemma2-9B at full width, 2 layers: 3 steps on (2, 2) (FSDP + TP)
    against rank 0's one-card steps on the same global batches (as 2
    microbatches of one row), within 1e-5 of max |p| of every
    parameter.  AdamW at eps 1e-3, as the CPU parity tests take it."""
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import OptConfig
    torch = r.torch
    cfg = r.config(GEMMA2, 2)
    opt_cfg = OptConfig(peak_lr=2e-3, warmup_steps=2, eps=1e-3)
    batches = gemma2_batches(r, cfg, 3)
    want, one = {}, None
    if r.rank == 0:
        r.reset_peak()
        model = T.init_params(cfg, 0, device=r.dev)
        one = train_steps(r, cfg, model, None, batches, opt_cfg, 2)
        one["peak_bytes"] = r.peak()
        want = {n: p.detach() for n, p in model.named_parameters()}
        del model
    r.both.agree(True)
    r.reset_peak()
    model = T.init_params(cfg, 0, mesh=r.both)
    got = train_steps(r, cfg, model, r.both, batches, opt_cfg)
    peaks = r.peaks()
    err = whole_rel(r, model, want)
    res = {"one_card": one, "four_cards": got, "max_rel": err,
           "peak_bytes_by_rank": peaks}
    if r.rank == 0:
        r.log(f"{cfg.name} {cfg.n_layers} layers at full width, 3 steps of "
              f"2 x {r.sizes['train_seq']} tokens (remat full, AdamW eps "
              f"1e-3, f32): on (data 2, model 2) vs one card: max |p - "
              f"p_one| / max |p_one| over the parameters {err:g} (max "
              f"1e-5); step walls {[round(w, 4) for w in got['walls']]} s "
              f"(one card {[round(w, 4) for w in one['walls']]} s), "
              f"losses {[round(x, 5) for x in got['losses']]} (one card "
              f"{[round(x, 5) for x in one['losses']]}); peak per rank "
              f"{[round(p / 2**30, 2) for p in peaks]} GiB (one card "
              f"{one['peak_bytes'] / 2**30:.2f}) [{r.card}]")
    r.check(err <= 1e-5, f"{cfg.name}: the (2, 2) steps differ from one "
            f"card: {err}")
    r.out["gemma2_cut"] = res


def phase_gemma2_train(r: Rank) -> None:
    """gemma2-9B whole at full width on (2, 2), FSDP + TP: a warm-up and
    `train_timed` steps of 2 x ``train_seq`` tokens, one row per data
    rank, remat "full", AdamW/WSD, f32, from seed 0."""
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import OptConfig
    torch, s = r.torch, r.sizes
    cfg = r.config(GEMMA2)
    r.reset_peak()
    model, secs = r.timed(lambda: T.init_params(cfg, 0, mesh=r.both))
    local = sum(p.numel() for p in model.parameters())
    batches = gemma2_batches(r, cfg, 1 + s["train_timed"])
    got = train_steps(r, cfg, model, r.both, batches, OptConfig())
    peaks = r.peaks()
    walls = sorted(got["walls"])
    med = walls[len(walls) // 2]
    tokens = 2 * s["train_seq"]
    flops = 8 * cfg.param_count() * tokens      # remat: forward twice
    res = {"step_s": got["walls"], "step_s_median": med,
           "tokens_per_s": tokens / med, "flop_per_s": flops / med,
           "flop_per_step": flops, "losses": got["losses"],
           "peak_bytes_by_rank": peaks, "calls_per_step": got["calls"],
           "state_bytes_per_rank": 16 * local, "init_s": secs,
           "param_count": cfg.param_count()}
    r.log(f"{cfg.name} {cfg.n_layers} layers, {cfg.param_count()} "
          f"parameters, on (data 2, model 2) FSDP + TP: made in {secs:.3f} "
          f"s; state (params, grads, mu, nu in f32) {16 * local} B "
          f"({16 * local / 1e9:.2f} GB) per rank; step of 2 x "
          f"{s['train_seq']} tokens (remat full, AdamW/WSD, f32): walls "
          f"{[round(w, 4) for w in got['walls']]} s, median {med:.4f} s, "
          f"{tokens / med:.1f} tokens/s, {flops / med / 1e12:.2f} TFLOP/s "
          f"over 4 cards ({flops:.3e} FLOP per step, 8·N·T); losses "
          f"{[round(x, 4) for x in got['losses']]}; peak per rank "
          f"{[round(p / 2**30, 2) for p in peaks]} GiB; collectives per "
          f"timed step {json.dumps(got['calls'])} [{r.card}]")
    r.check(all(math.isfinite(x) for x in got["losses"]),
            f"non-finite losses {got['losses']}")
    r.out["gemma2_train"] = res


def fill_zamba2(torch, caches, cfg, upto: int, chunk: int, seed: int,
                mesh, dev) -> None:
    """Seeded draws into zamba2's caches, as one card holds them or as a
    rank of ``mesh`` (the sequence split over ``data``, the heads over
    ``model``): ``attn.k``/``v`` at the global positions below ``upto``,
    drawn in chunks of ``chunk`` positions whose seed is the group, the
    tensor and the chunk's index (a layout changes no number), and the
    ``ssm``/``conv`` states drawn whole and cut to the rank's heads and
    channels."""
    from repro_torch.models import shardings as SH
    k = caches["attn"]["k"]
    groups, b, n_loc, kv_loc, hd = k.shape
    m = SH.model_extent(mesh)
    j = mesh.axis_index("model") if m > 1 else 0
    lo = mesh.axis_index("data") * n_loc if isinstance(
        caches, SH.SeqSplitCaches) else 0
    if n_loc % chunk:
        raise ValueError(f"{n_loc} positions per rank in chunks of {chunk}")
    gen = torch.Generator(device=dev)
    for g in range(groups):
        for w, t in enumerate((caches["attn"]["k"], caches["attn"]["v"])):
            for c0 in range(lo, min(lo + n_loc, upto), chunk):
                gen.manual_seed(seed * 1_000_003 + (2 * g + w) * 65_536
                                + c0 // chunk)
                blk = torch.randn(b, chunk, cfg.n_kv_heads, hd,
                                  generator=gen, device=dev) * 0.5
                n = min(chunk, upto - c0)
                t[g, :, c0 - lo:c0 - lo + n] = \
                    blk[:, :n, j * kv_loc:(j + 1) * kv_loc]
    gen.manual_seed(seed)
    layers, _, nh_loc = caches["ssm"].shape[:3]
    ssm = torch.randn((layers, b, cfg.ssm_nheads) + caches["ssm"].shape[3:],
                      generator=gen, device=dev) * 0.1
    caches["ssm"].copy_(ssm[:, :, j * nh_loc:(j + 1) * nh_loc])
    conv = torch.randn(caches["conv"].shape[:3]
                       + (cfg.d_inner + 2 * cfg.ssm_state,), generator=gen,
                       device=dev) * 0.5
    caches["conv"].copy_(SH.tp_block("mamba.conv_b", conv, cfg, mesh))


def zamba2_decode(r: Rank, cfg, model, mesh, max_len: int) -> dict:
    """B = 1: the caches filled from seeded draws (`fill_zamba2`) up to
    max_len − ``steps``, then ``steps`` teacher-forced decode steps to
    the end; returns the logits, walls, collectives per step and the
    rank's cache bytes."""
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import decode_step
    torch, s = r.torch, r.sizes
    upto = max_len - s["steps"]
    gen = torch.Generator(device=r.dev).manual_seed(58)
    toks = torch.randint(0, cfg.vocab, (1, s["steps"]), generator=gen,
                         device=r.dev)
    caches = T.init_caches(cfg, 1, max_len, device=r.dev, mesh=mesh)
    fill_zamba2(torch, caches, cfg, upto, s["fill_chunk"], 58, mesh, r.dev)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (caches["attn"]["k"], caches["attn"]["v"],
                                caches["ssm"], caches["conv"]))
    logits, walls, calls = [], [], []
    with torch.no_grad(), (SH.use_mesh(mesh) if mesh is not None
                           else contextlib.nullcontext()):
        for i in range(s["steps"]):
            (lg, c), wall = r.timed(lambda: counted(r, lambda: decode_step(
                model, cfg, toks[:, i:i + 1], caches, upto + i)[0]))
            logits.append(lg)
            walls.append(wall)
            calls.append(c)
    del caches
    return {"logits": torch.stack(logits, 1), "walls": walls,
            "calls": calls, "cache_bytes": cache_bytes}


def phase_zamba2_cp_cut(r: Rank) -> None:
    """zamba2-2.7B whole at B = 1, max_len ``cut_len``: the decode on
    (data 2, model 2), caches split by sequence over data, against rank
    0's one card from the same draws, within 1e-4 of max |logits|."""
    from repro_torch.models import transformer as T
    torch, s = r.torch, r.sizes
    cfg = r.config(ZAMBA2)
    want = None
    if r.rank == 0:
        model = T.init_params(cfg, 0, device=r.dev)
        want = zamba2_decode(r, cfg, model, None, s["cut_len"])["logits"]
        del model
    r.both.agree(True)
    r.reset_peak()
    model = T.init_params(cfg, 0, mesh=r.both)
    got = zamba2_decode(r, cfg, model, r.both, s["cut_len"])
    err = rel(torch, got["logits"], want) if r.rank == 0 else 0.0
    walls = sorted(got["walls"])
    res = {"max_rel": err, "cache_bytes": got["cache_bytes"],
           "decode_ms_median": walls[len(walls) // 2] * 1e3}
    r.log(f"{cfg.name} B=1 max_len={s['cut_len']}: {s['steps']} decode "
          f"steps on (data 2, model 2), the KV cache's sequence split over "
          f"data ({got['cache_bytes']} B of caches per rank), vs one card "
          f"from the same draws: max |err| / max |logits| {err:g} (max "
          f"1e-4); ms per step median {res['decode_ms_median']:.3f} "
          f"[{r.card}]")
    r.check(err <= 1e-4, f"{cfg.name}: the context-parallel decode differs "
            f"from one card: {err}")
    r.out["zamba2_cp_cut"] = res


def phase_zamba2_long(r: Rank) -> None:
    """zamba2-2.7B whole at B = 1, max_len ``long_len``
    (``SHAPES["long_500k"]``) on (data 2, model 2): the caches filled
    from seeded draws to max_len − ``steps`` (the hybrid's prefill runs
    token by token: that many prompt steps are out of reach), then
    ``steps`` decode steps: ms per step, the rank's cache bytes, peak
    memory, the collectives per step, and the step's read bound (the
    rank's gathered weights and its caches at the card's data-sheet
    rate)."""
    from repro_torch.models import transformer as T
    torch, s = r.torch, r.sizes
    cfg = r.config(ZAMBA2)
    r.reset_peak()
    model = T.init_params(cfg, 0, mesh=r.both)
    gathered = sum(p.numel() * p.element_size()
                   * (2 if p.fsdp_dim is not None else 1)
                   for p in model.parameters())
    got = zamba2_decode(r, cfg, model, r.both, s["long_len"])
    peaks = r.peaks()
    logits = got["logits"]
    r.check(bool(torch.isfinite(logits).all()) and logits.shape == (
        1, s["steps"], cfg.vocab_pad), f"{cfg.name}: logits of shape "
        f"{tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    walls = sorted(got["walls"])
    bound = (gathered + got["cache_bytes"]) / PEAK_BYTES_PER_S * 1e3
    res = {"decode_ms": [w * 1e3 for w in got["walls"]],
           "decode_ms_median": walls[len(walls) // 2] * 1e3,
           "decode_ms_min": walls[0] * 1e3,
           "cache_bytes": got["cache_bytes"], "gathered_weight_bytes":
           gathered, "bound_ms": bound, "peak_bytes_by_rank": peaks,
           "calls_per_step": got["calls"][-1]}
    r.log(f"{cfg.name} B=1 max_len={s['long_len']} on (data 2, model 2): "
          f"caches {got['cache_bytes']} B ({got['cache_bytes'] / 1e9:.2f} "
          f"GB) per rank, filled to position {s['long_len'] - s['steps']}; "
          f"{s['steps']} decode steps: ms per step median "
          f"{res['decode_ms_median']:.3f} (min {res['decode_ms_min']:.3f}) "
          f"against the read bound {bound:.3f} ms (the rank's gathered "
          f"weights {gathered} B + caches, {PEAK_BYTES_PER_S:.3g} B/s); "
          f"peak per rank {[round(p / 2**30, 2) for p in peaks]} GiB; "
          f"collectives per step {json.dumps(res['calls_per_step'])} "
          f"[{r.card}]")
    r.out["zamba2_long"] = res


#: the modes in the order they run (``--modes`` picks some)
MODES = {"cut": phase_cut, "llama4": phase_llama4,
         "internvl2": phase_internvl2, "dp": phase_dp,
         "deepseek_cut": lambda r: phase_cut(r, DEEPSEEK, "deepseek_cut_rel"),
         "deepseek": phase_deepseek,
         "zamba2": lambda r: family_mode(r, ZAMBA2),
         "rwkv6": lambda r: family_mode(r, RWKV6),
         "whisper": lambda r: family_mode(r, WHISPER),
         "gemma2_cut": phase_gemma2_cut, "gemma2_train": phase_gemma2_train,
         "zamba2_cp_cut": phase_zamba2_cp_cut,
         "zamba2_long": phase_zamba2_long}


def run_rank(rank: int, store: str, dev: str, out: Path, modes) -> int:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.ranks import join
    dev = join(rank, WORLD, store, dev, timeout=COLLECTIVE_TIMEOUT)
    torch.backends.cuda.matmul.allow_tf32 = False
    r = Rank(rank, dev, SIZES["cpu" if dev == "cpu" else "cuda"])
    try:
        for mode in modes:
            MODES[mode](r)
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
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma-separated, of " + ", ".join(MODES))
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    modes = [m for m in args.modes.split(",") if m]
    bad = [m for m in modes if m not in MODES]
    if bad or not modes:
        ap.error(f"unknown modes {bad}: pick from {', '.join(MODES)}")
    if args.rank is not None:
        return run_rank(args.rank, args.store, args.device, out, modes)
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
                             str(store), "--modes", ",".join(modes)],
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
