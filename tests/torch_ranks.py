"""Multi-rank runs for the port's distributed tests: CPU processes joined
by ``torch.distributed`` with gloo through a ``file://`` store (no
network), and the JAX package's runs on fake host devices.

    python tests/torch_ranks.py JOB OUT [RANK WORLD STORE INPUTS DEVICE]

runs ``JOB`` (a function below) and writes its arrays to ``OUT``, an
``.npz`` file.  A ``rank_*`` job runs as rank RANK of WORLD ranks of the
port, which imports no jax: the JAX package's draws come in the
``INPUTS`` file.  DEVICE ``cpu`` joins the ranks with gloo, ``cuda``
puts rank r on card r and joins them with NCCL.  A ``ref_*`` job runs
the JAX package alone, on as many host devices as ``XLA_FLAGS`` makes.
`run_ranks` and `run_reference` start them from a test, each process
with its own timeout.

The same jobs hold the port on 4 cards against its 4 gloo CPU ranks:

    python tests/torch_ranks.py expect DIR       # on the CPU, with jax
    python tests/torch_ranks.py cuda-check DIR   # on a host with 4 cards

``expect`` writes each job's inputs and the gloo ranks' outputs under
DIR; ``cuda-check`` runs the jobs on 4 cards, requires every output that
no generator draw feeds to equal the CPU ranks' (bit for bit) and the
rest to meet the jobs' contracts (replicated over the ranks, layouts
identical, feasible, never above member 0), prints one JSON line and
exits 1 on a failure.

The graphs every job rebuilds from seeds (`GRID`, `HG`) are the same in
both packages.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 180            # seconds, per process or world of ranks

# parhip: grid2d(32, 32), k = 4; parhyp: planted_hypergraph(300, 450), k = 4
GRID = (32, 32)
HG = dict(n=300, m=450, blocks=4, seed=7)
K = 4
ROUNDS = 6
SEED = 3


def _env(**extra) -> dict:
    from repro_torch.launch.ranks import rank_env
    return rank_env(ROOT / "src", JAX_PLATFORMS="cpu", **extra)


def run_ranks(job: str, world: int, tmp: Path, device: str = "cpu",
              **inputs) -> list:
    """Run ``job`` on ``world`` ranks (``device`` ``cpu``: gloo, ``cuda``:
    NCCL, one card each) with the arrays ``inputs``; returns each rank's
    arrays."""
    from repro_torch.launch.ranks import spawn
    tmp = tmp.resolve()
    store, inp = tmp / f"{job}.store", tmp / f"{job}-inputs.npz"
    np.savez(inp, **inputs)
    logs = [tmp / f"{job}-{r}.log" for r in range(world)]
    codes = spawn(lambda r: [__file__, job, str(tmp / f"{job}-{r}.npz"),
                             str(r), str(world), str(store), str(inp),
                             device],
                  world, logs, TIMEOUT, store, env=_env())
    for r, code in enumerate(codes):
        if code != 0:
            raise AssertionError(f"{job} rank {r} exited {code}:\n"
                                 f"{logs[r].read_text()}")
    return [dict(np.load(tmp / f"{job}-{r}.npz")) for r in range(world)]


def run_reference(job: str, devices: int, tmp: Path, **inputs) -> dict:
    """Run the JAX package's ``job`` on ``devices`` fake host devices
    (with the arrays ``inputs``, where given)."""
    out = tmp / f"{job}.npz"
    args = [sys.executable, __file__, job, str(out)]
    if inputs:
        np.savez(tmp / f"{job}-inputs.npz", **inputs)
        args.append(str(tmp / f"{job}-inputs.npz"))
    r = subprocess.run(
        args, capture_output=True,
        text=True, timeout=TIMEOUT, env=_env(
            XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}"))
    if r.returncode != 0:
        raise AssertionError(f"{job} exited {r.returncode}:\n{r.stdout}"
                             f"{r.stderr}")
    return dict(np.load(out))


# -- shared inputs --------------------------------------------------------------

def parhip_noise(rows: int, shards: int) -> np.ndarray:
    """The reference's draws of a parhip refinement, (S, rounds, rows, k):
    ``uniform(fold_in(key_r, s), (rows, k))`` for shard s."""
    import jax
    import jax.numpy as jnp
    keys = jax.random.split(jax.random.PRNGKey(SEED), ROUNDS)
    return np.stack([np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(kr, s), (rows, K), jnp.float32, 0.0, 1e-4))
        for kr in keys]) for s in range(shards)])


def grid_part0(n: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, K, n)


def parhyp_noise(n_pad: int, k_pad: int) -> np.ndarray:
    """The reference's draws of a refinement: ``uniform(key_r, (n_pad,
    k_pad))`` for key_r in ``split(PRNGKey(SEED), ROUNDS)``."""
    import jax
    import jax.numpy as jnp
    return np.stack([np.asarray(jax.random.uniform(
        kr, (n_pad, k_pad), jnp.float32, 0.0, 1e-4))
        for kr in jax.random.split(jax.random.PRNGKey(SEED), ROUNDS)])


def part0_of(hg) -> np.ndarray:
    return np.random.default_rng(1).integers(0, K, hg.n)


# -- the JAX package on fake devices ---------------------------------------------

def ref_parhip() -> dict:
    """``_parhip_refine_jit`` on a 4-device ``nodes`` mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import parhip as P
    from repro.io.generators import grid2d
    g = grid2d(*GRID)
    sg = P.shard_graph(g, 4)
    labels0 = np.zeros(sg.n_pad, np.int32)
    labels0[:g.n] = grid_part0(g.n)
    cap = jnp.full((K,), 1.03 * np.ceil(g.total_vwgt() / K), jnp.float32)
    mesh = Mesh(np.array(jax.devices()), ("nodes",))
    out = P._parhip_refine_jit(
        mesh, *(jnp.asarray(a) for a in (sg.src, sg.dst, sg.w, sg.vwgt)),
        jnp.asarray(labels0), cap, jax.random.PRNGKey(SEED), sg.rows, K,
        ROUNDS, 4, "nodes")
    return {"labels": np.asarray(out)}


def ref_parhyp() -> dict:
    """parhyp_refine on a (4,) mesh and the (2, 2) device hierarchy."""
    import jax
    from jax.sharding import Mesh
    from repro import obs
    from repro.core.hypergraph import dist as D
    from repro.core.hypergraph.driver import PRESETS
    from repro.io.generators import planted_hypergraph
    hg = planted_hypergraph(**HG)
    devs = np.array(jax.devices())
    out = {"refine4": D.parhyp_refine(
        hg, part0_of(hg), K, mesh=Mesh(devs, ("nets",)), rounds=ROUNDS,
        seed=SEED)}
    sh = D.shard_hypergraph(hg, (2, 2))
    levels, n_c = D._device_hierarchy(
        sh, Mesh(devs.reshape(2, 2), ("nets", "verts")), PRESETS["fast"], K,
        1, obs.NULL)
    out["levels"] = np.asarray(len(levels))
    out["n_coarse"] = np.asarray(n_c)
    for i, L in enumerate(levels):
        for f in ("pv", "pe", "mask", "netw", "esize", "vwgt", "coarse_of"):
            if getattr(L, f) is not None:
                out[f"{f}{i}"] = np.asarray(getattr(L, f))
    return out


# -- the port on gloo ranks -------------------------------------------------------

def rank_parhip(rank: int, world: int, inp: dict, dev: str) -> dict:
    """The 4-shard parhip round given the reference's draws
    (``inp["noise"]``), and parhip end to end."""
    import torch
    from repro_torch.core import parhip as P
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.partition import edge_cut, is_feasible
    from repro_torch.io.generators import grid2d
    g = grid2d(*GRID)
    mesh = Mesh.world(("nodes",), device=dev)
    sg = P.shard_graph(g, world)
    labels0 = np.zeros(sg.n_pad, np.int32)
    labels0[:g.n] = grid_part0(g.n)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = P._parhip_refine(
        mesh, t(sg.src[rank]), t(sg.dst[rank]), t(sg.w[rank]),
        t(sg.vwgt.reshape(-1)), t(labels0),
        torch.full((K,), 1.03 * np.ceil(g.total_vwgt() / K), device=dev),
        t(inp["noise"][rank]), sg.rows, K, ROUNDS)
    part = P.parhip(g, K, 0.03, "fastmesh", seed=1, mesh=mesh)
    return {"labels": out.cpu().numpy(), "part": part,
            "cut": np.asarray(edge_cut(g, part)),
            "feasible": np.asarray(is_feasible(g, part, K, 0.03))}


def rank_parhyp(rank: int, world: int, inp: dict, dev: str) -> dict:
    """The three 4-rank layouts' refinement (the reference's draws,
    ``inp["noise"]``, and the production generator), the (2, 2) hierarchy
    and parhyp on (2, 2)."""
    import torch
    from repro_torch import obs
    from repro_torch.core.hypergraph import dist as D
    from repro_torch.core.hypergraph.driver import PRESETS
    from repro_torch.core.hypergraph.metrics import connectivity, is_feasible
    from repro_torch.core.mesh import Mesh
    from repro_torch.io.generators import planted_hypergraph
    hg = planted_hypergraph(**HG)
    part0 = part0_of(hg)
    noise = torch.from_numpy(inp["noise"])
    out = {}
    for name, shape, axes in (("4", (4,), ("nets",)),
                              ("41", (4, 1), ("nets", "verts")),
                              ("14", (1, 4), ("nets", "verts"))):
        mesh = Mesh.world(axes, shape, device=dev)
        out[f"draws{name}"] = D.parhyp_refine(hg, part0, K, mesh=mesh,
                                              rounds=ROUNDS, seed=SEED,
                                              noise=noise)
        out[f"gen{name}"] = D.parhyp_refine(hg, part0, K, mesh=mesh,
                                            rounds=ROUNDS, seed=SEED)
    mesh22 = Mesh.world(("nets", "verts"), (2, 2), device=dev)
    levels, n_c = D._device_hierarchy(D.shard_hypergraph(hg, (2, 2)), mesh22,
                                      PRESETS["fast"], K, 1, obs.NULL)
    out["levels"] = np.asarray(len(levels))
    out["n_coarse"] = np.asarray(n_c)
    for i, L in enumerate(levels):
        for f in ("pv", "pe", "mask", "netw", "esize", "vwgt", "coarse_of"):
            if getattr(L, f) is not None:
                out[f"{f}{i}"] = getattr(L, f).cpu().numpy()
    rec = obs.Recorder()
    D._DEVICE_MIN_N = 0     # the device V-cycle on a 300-vertex input
    part = D.parhyp(hg, K, 0.03, "fast", seed=1, mesh=mesh22, report=rec)
    out["part22"] = part
    out["km1_22"] = np.asarray(connectivity(hg, part))
    out["feasible22"] = np.asarray(is_feasible(hg, part, K, 0.03))
    out["device_levels22"] = np.asarray(
        rec.counters().get("parhyp/device_levels", 0))
    return out


def rank_memetic(rank: int, world: int, inp: dict, dev: str) -> dict:
    """ring_roll at I = 4, 6, 8 over every shift, kaffpaE with and without
    an islands mesh and on a wall-clock budget, kahyparE with its parhyp
    polish."""
    from repro_torch import obs
    from repro_torch.core import evolve as E
    from repro_torch.core import memetic as MEM
    from repro_torch.core import hypergraph as H
    from repro_torch.core.mesh import PPERMUTE, Mesh
    from repro_torch.io.generators import grid2d, planted_hypergraph
    mesh = Mesh.world(("islands",), device=dev)
    out = {}
    rng = np.random.default_rng(0)
    for n_isl in (4, 6, 8):
        parts = rng.integers(0, 9, (n_isl, 37)).astype(np.int32)
        before = obs.metrics.get(PPERMUTE)
        ok = [np.array_equal(MEM.ring_roll(parts, s, mesh),
                             np.roll(parts, s, axis=0))
              for s in range(-1, n_isl + 1)]
        out[f"roll{n_isl}"] = np.asarray(ok)
        out[f"ppermutes{n_isl}"] = np.asarray(
            obs.metrics.get(PPERMUTE) - before)
    g = grid2d(16, 16)
    kw = dict(n_islands=4, population=2, generations=2, seed=1, device=dev)
    out["kaffpaE_mesh"] = E.kaffpaE(g, 4, 0.03, "fast", mesh=mesh, **kw)
    out["kaffpaE_none"] = E.kaffpaE(g, 4, 0.03, "fast", **kw)
    # a wall-clock budget: the ranks agree every generation on going on
    kw["generations"] = None
    out["kaffpaE_timed"] = E.kaffpaE(g, 4, 0.03, "fast", mesh=mesh,
                                     time_limit=2.0, **kw)
    hg = planted_hypergraph(200, 300, blocks=4, seed=11)
    part = H.kahyparE(hg, 4, 0.03, "fast", seed=1, n_islands=4,
                      population=1, generations=2, mesh=mesh, device=dev)
    out["kahyparE"] = part
    out["kahyparE_km1"] = np.asarray(H.connectivity(hg, part))
    out["kahyparE_feasible"] = np.asarray(H.is_feasible(hg, part, 4, 0.03))
    out["kahypar_km1"] = np.asarray(H.connectivity(hg, H.kahypar(
        hg, 4, 0.03, "fast", seed=1, device=dev)))
    return out


# -- the decoder stack across ranks: tensor, expert and data parallelism -------

#: the tensor-parallel forward and decode: reduced configs, starcoder2 with
#: 4 KV heads (the divisible KV path; the others have 1 KV head, replicated
#: per GQA group), on (data, model) meshes
TP_ARCHS = ("llama4_scout_17b_a16e", "minicpm_2b", "internvl2_26b",
            "starcoder2_15b")
TP_MESHES = {"14": (1, 4), "22": (2, 2), "41": (4, 1)}
TP_RUNS = [(a, "14") for a in TP_ARCHS] + [("llama4_scout_17b_a16e", "22")]
TP_B, TP_S, TP_STEPS = 4, 16, 3
#: moe_ffn_a2a alone: llama4-scout reduced (8 experts, top-1) at capacity
#: factor 1.25, where the per-(source → expert) capacity drops tokens
MOE_ARCH, MOE_B, MOE_S = "llama4_scout_17b_a16e", 4, 64
#: the data-parallel train step: minicpm and llama4-scout (a MoE layer
#: whose dispatch group is the global batch) reduced, from the reference's
#: weights, a global batch of 8 rows over data = 4, three steps
DP_ARCHS, DP_B, DP_S, DP_STEPS = ("minicpm_2b", "llama4_scout_17b_a16e"), \
    8, 16, 3
DP_OPT = dict(peak_lr=2e-3, warmup_steps=2, eps=1e-3)


def stack_config(arch: str, get_config):
    """The reduced config of ``arch`` from either package's
    ``get_config``; starcoder2 with 4 KV heads."""
    import dataclasses
    cfg = get_config(arch).reduced()
    if arch == "starcoder2_15b":
        cfg = dataclasses.replace(cfg, n_kv_heads=4)
    return cfg


def flat_tree(tree, prefix: str) -> dict:
    """{"<prefix>/blocks/attn/wq": array} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def nest_tree(arrays: dict, prefix: str) -> dict:
    """The inverse of `flat_tree` for the keys under ``prefix``."""
    tree = {}
    for key, a in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        *parents, last = key[len(prefix) + 1:].split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = a
    return tree


def stack_inputs() -> dict:
    """The reference's weights (``init_params`` at PRNGKey(0), ``init_moe``
    at PRNGKey(3)) and the seeded tokens, prefixes and activations of the
    stack jobs."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models import moe as rM
    from repro.models import transformer as rT
    rng = np.random.default_rng(11)
    out = {}
    for arch in TP_ARCHS:
        cfg = stack_config(arch, get_config)
        out.update(flat_tree(jax.tree.map(np.asarray, rT.init_params(
            cfg, jax.random.PRNGKey(0))), f"w/{arch}"))
        out[f"tok/{arch}"] = rng.integers(0, cfg.vocab, (TP_B, TP_S)) \
            .astype(np.int32)
        if cfg.n_prefix_embeds:
            out[f"prefix/{arch}"] = (rng.standard_normal(
                (TP_B, cfg.n_prefix_embeds, cfg.d_model)) * 0.1) \
                .astype(np.float32)
    cfg = stack_config(MOE_ARCH, get_config)
    out.update(flat_tree(jax.tree.map(np.asarray, rM.init_moe(
        jax.random.PRNGKey(3), cfg, jnp.float32)), "moe"))
    out["moe_x"] = rng.standard_normal((MOE_B, MOE_S, cfg.d_model)) \
        .astype(np.float32)
    out["moe_x1"] = rng.standard_normal((MOE_B, 1, cfg.d_model)) \
        .astype(np.float32)
    out["perm"] = rng.permutation(cfg.n_experts)
    for arch in DP_ARCHS:
        out[f"dp_tokens/{arch}"] = rng.integers(0, stack_config(
            arch, get_config).vocab, (DP_STEPS, DP_B, DP_S + 1)) \
            .astype(np.int32)
    return out


def tie_records(torch, names, gs, errs, ties, amax=None) -> dict:
    """The int8 compression's rounding ties, or'ed into ``ties``: per
    parameter name, the elements whose pre-quantization value g / scale
    (one scale over the group, as ``train_step._compress_group`` takes
    it: ``amax``, where given, is ``train_step.group_amax``, the max over
    the ranks that hold parts of the leaf) lies within 5e-4 of a
    half-integer, where f32 noise may pick the other int8 code."""
    g = [a.float() + e for a, e in zip(gs, errs)]
    top = (amax(g) if amax is not None
           else torch.stack([a.abs().max() for a in g]).max())
    scale = top / 127.0 + 1e-12
    out = {}
    for n, x in zip(names, g):
        r = (x / scale).cpu().numpy()
        tie = np.abs(np.abs(r) % 1.0 - 0.5) <= 5e-4
        out[n] = ties.get(n, np.zeros_like(tie)) | tie
    return out


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))


def ref_stack(inp: dict) -> dict:
    """The JAX package under ``shardings.use_mesh`` of (data, model) meshes
    on 4 fake devices: each `TP_RUNS` forward, its prefill of TP_S −
    TP_STEPS tokens (after the prefix) and TP_STEPS teacher-forced decode
    steps; ``moe_ffn_a2a`` at each `TP_MESHES` mesh on (B, 64) and (B, 1)
    tokens, and ``moe_ffn`` without a mesh; three train steps of each
    `DP_ARCHS` arch on (data 4, model 1) with the int8 compression."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models import moe as rM
    from repro.models import shardings as rSH
    from repro.models import transformer as rT
    from repro.serve import serve_step as rS
    from repro.train import optimizer as rO
    from repro.train import train_step as rTS
    out = {}
    for arch, name in TP_RUNS:
        cfg = stack_config(arch, get_config)
        params = jax.tree.map(jnp.asarray, nest_tree(inp, f"w/{arch}"))
        toks = jnp.asarray(inp[f"tok/{arch}"])
        kw = ({"prefix_embeds": jnp.asarray(inp[f"prefix/{arch}"])}
              if f"prefix/{arch}" in inp else {})
        n_pre = cfg.n_prefix_embeds if kw else 0
        p0 = TP_S - TP_STEPS
        with rSH.use_mesh(_jax_mesh(TP_MESHES[name])):
            out[f"fwd/{arch}/{name}"] = np.asarray(jax.jit(
                lambda p, t, kw: rT.forward(p, cfg, t, **kw)[0])(
                    params, toks, kw))
            caches = rT.init_caches(cfg, TP_B, TP_S + n_pre)
            lg, caches = jax.jit(
                lambda p, t, c, kw: rS.prefill_step(p, cfg, t, c, **kw))(
                    params, toks[:, :p0], caches, kw)
            steps = [lg]
            dec = jax.jit(lambda p, t, c, pos: rS.decode_step(p, cfg, t, c,
                                                              pos))
            for i in range(TP_STEPS):
                lg, caches = dec(params, toks[:, p0 + i:p0 + i + 1], caches,
                                 jnp.int32(n_pre + p0 + i))
                steps.append(lg)
            out[f"dec/{arch}/{name}"] = np.stack(
                [np.asarray(a) for a in steps], 1)
    cfg = stack_config(MOE_ARCH, get_config)
    p = jax.tree.map(jnp.asarray, nest_tree(inp, "moe"))
    ffn = jax.jit(lambda p, x: rM.moe_ffn_a2a(p, x, cfg))
    for name, shape in TP_MESHES.items():
        with rSH.use_mesh(_jax_mesh(shape)):
            out[f"a2a/{name}"] = np.asarray(ffn(p, inp["moe_x"]))
            out[f"a2a1/{name}"] = np.asarray(ffn(p, inp["moe_x1"]))
    out["moe_ffn"] = np.asarray(rM.moe_ffn(p, jnp.asarray(inp["moe_x"]),
                                           cfg))
    for arch in DP_ARCHS:
        cfg = stack_config(arch, get_config)
        params = jax.tree.map(jnp.asarray, nest_tree(inp, f"w/{arch}"))
        opt = rTS.init_opt_state(params, True)
        step = jax.jit(rTS.make_train_step(cfg, rO.OptConfig(**DP_OPT),
                                           remat="full", grad_compress=True))
        losses = []
        with rSH.use_mesh(_jax_mesh(TP_MESHES["41"])):
            for i in range(DP_STEPS):
                params, opt, metrics = step(params, opt, {
                    "tokens": jnp.asarray(inp[f"dp_tokens/{arch}"][i])})
                losses.append(float(metrics["loss"]))
        out[f"dp/{arch}/loss"] = np.asarray(losses)
        out.update(flat_tree(jax.tree.map(np.asarray, params),
                             f"dp/{arch}/ref"))
    return out


def _whole(SH, model, name: str, t):
    """The whole parameter ``name`` (or a tensor shaped as the rank holds
    it) from every rank's block, as numpy."""
    if model.mesh is None:
        return t.detach().cpu().numpy()
    return SH.whole_leaf(name, t.detach(), model.cfg, model.mesh) \
        .cpu().numpy()


def _rows(mesh, b: int) -> slice:
    """The rank's rows of a global batch of ``b`` (split over the data
    axes)."""
    from repro_torch.models import shardings as SH
    i, n = SH.block_index(SH._fs_entry(mesh.axis_names), mesh)
    return slice(i * b // n, (i + 1) * b // n)


def rank_stack(rank: int, world: int, inp: dict, dev: str) -> dict:
    """The port's side of `ref_stack`, each rank on its rows, plus the
    collectives a forward issues, ``place_experts`` over the model axis,
    and three data-parallel train steps on (data=4, model=1) with the
    int8 compression (the pre-quantization values g / scale that lie at a
    rounding tie recorded per parameter), then a checkpointed run with an
    injected failure (rank 0 writes, every rank restores).  Under FSDP
    the trained parameters and their ties are written whole, reassembled
    from the ranks' shards."""
    import torch
    from repro_torch import obs
    from repro_torch.configs.base import get_config
    from repro_torch.core.mesh import ALL_GATHER, ALL_REDUCE, ALL_TO_ALL, Mesh
    from repro_torch.models import moe as M
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import ParamTree
    from repro_torch.models.weights import params_from_jax, reference_tree
    from repro_torch.serve.serve_step import decode_step, prefill_step
    from repro_torch.train import fault
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig
    meshes = {name: Mesh.world(("data", "model"), shape, device=dev)
              for name, shape in TP_MESHES.items()}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = {}
    # the collectives alone: rank r sends 10·r + j to rank j of the axis
    m14 = meshes["14"]
    send = torch.arange(4, device=dev) + 10 * m14.axis_index("model")
    out["probe_a2a"] = m14.all_to_all(send[:, None], "model").cpu().numpy()
    m22 = meshes["22"]
    me = torch.tensor([[rank]], device=dev)
    out["probe_gather_model"] = m22.all_gather(me, "model", dim=1) \
        .cpu().numpy()
    out["probe_gather_data"] = m22.all_gather(me, "data").cpu().numpy()
    out["probe_gather_all"] = m22.all_gather(me).cpu().numpy()
    # a sharded init holds the unsharded model's blocks
    cfg = stack_config("llama4_scout_17b_a16e", get_config)
    full = T.init_params(cfg, 5, device=dev)
    out["init_equal"] = np.asarray([all(
        torch.equal(q, SH.rank_block(n, full.get_parameter(n), cfg, mesh))
        for n, q in T.init_params(cfg, 5, device=dev, mesh=mesh)
        .named_parameters()) for mesh in (meshes["14"], meshes["22"])])
    counts = (ALL_REDUCE, ALL_GATHER, ALL_TO_ALL)
    for arch, name in TP_RUNS:
        cfg = stack_config(arch, get_config)
        mesh = meshes[name]
        rows = _rows(mesh, TP_B)
        model = params_from_jax(nest_tree(inp, f"w/{arch}"), cfg,
                                device=dev, mesh=mesh)
        toks = t(inp[f"tok/{arch}"][rows])
        prefix = (t(inp[f"prefix/{arch}"][rows]) if f"prefix/{arch}" in inp
                  else None)
        n_pre = cfg.n_prefix_embeds if prefix is not None else 0
        p0 = TP_S - TP_STEPS
        with torch.no_grad(), SH.use_mesh(mesh):
            before = {c: obs.metrics.get(c) for c in counts}
            out[f"fwd/{arch}/{name}"] = T.forward(
                model, cfg, toks, prefix_embeds=prefix)[0].cpu().numpy()
            out[f"calls/{arch}/{name}"] = np.asarray(
                [obs.metrics.get(c) - before[c] for c in counts])
            caches = T.init_caches(cfg, TP_B, TP_S + n_pre, device=dev,
                                   mesh=mesh)
            steps = [prefill_step(model, cfg, toks[:, :p0], caches,
                                  prefix_embeds=prefix)[0]]
            for i in range(TP_STEPS):
                steps.append(decode_step(model, cfg,
                                         toks[:, p0 + i:p0 + i + 1], caches,
                                         n_pre + p0 + i)[0])
            out[f"dec/{arch}/{name}"] = torch.stack(steps, 1).cpu().numpy()
            out[f"kv/{arch}/{name}"] = np.asarray(caches["k"].shape)
    cfg = stack_config(MOE_ARCH, get_config)
    whole = {k: t(v) for k, v in nest_tree(inp, "moe").items()}
    for name, mesh in meshes.items():
        p = ParamTree({k: SH.tp_block(f"moe.{k}", v, cfg, mesh)
                       for k, v in whole.items()})
        rows = _rows(mesh, MOE_B)
        with torch.no_grad(), SH.use_mesh(mesh):
            out[f"a2a/{name}"] = M.moe_ffn_a2a(
                p, t(inp["moe_x"][rows]), cfg).cpu().numpy()
            out[f"a2a1/{name}"] = M.moe_ffn_a2a(
                p, t(inp["moe_x1"][rows]), cfg).cpu().numpy()
            out[f"a2a1_rows/{name}"] = M.moe_ffn_a2a(
                p, t(inp["moe_x1"][rows]), cfg, per_row=True).cpu().numpy()
        if name == "14":
            placed = M.place_experts(p, inp["perm"], mesh)
            out["placed_w_gate"] = placed.w_gate.cpu().numpy()
            out["placed_router"] = placed.router.cpu().numpy()
    # data parallelism: (data 4, model 1), from the reference's weights
    mesh = meshes["41"]
    rows = _rows(mesh, DP_B)
    ties, real = {}, TS._compress_group
    for arch in DP_ARCHS:
        cfg = stack_config(arch, get_config)
        model = params_from_jax(nest_tree(inp, f"w/{arch}"), cfg, device=dev,
                                mesh=mesh)
        opt = TS.init_opt_state(model, grad_compress=True)
        step = TS.make_train_step(cfg, OptConfig(**DP_OPT), remat="full",
                                  grad_compress=True)
        ties.clear()

        def recording(gs, errs):
            names = {id(q.grad): n for n, q in model.named_parameters()}
            ties.update(tie_records(torch, [names[id(a)] for a in gs], gs,
                                    errs, ties, TS.group_amax))
            return real(gs, errs)

        TS._compress_group = recording
        losses = []
        try:
            with SH.use_mesh(mesh):
                for i in range(DP_STEPS):
                    model, opt, metrics = step(model, opt, {
                        "tokens": t(inp[f"dp_tokens/{arch}"][i][rows])})
                    losses.append(float(metrics["loss"]))
        finally:
            TS._compress_group = real
        out[f"dp/{arch}/loss"] = np.asarray(losses)
        for n, q in model.named_parameters():
            out[f"dp/{arch}/p/{n}"] = _whole(SH, model, n, q)
            out[f"dp/{arch}/tie/{n}"] = _whole(SH, model, n, torch.from_numpy(
                ties[n]).float().to(dev)) > 0.5
    # checkpoints under the mesh: a failure injected at step 1 of 2
    cfg = stack_config("minicpm_2b", get_config)
    small = params_from_jax(reference_tree(T.init_params(cfg, 1,
                                                         device="cpu")),
                            cfg, device=dev, mesh=mesh)
    state = TS.init_opt_state(small)
    plain = TS.make_train_step(cfg, OptConfig(**DP_OPT), remat="none")

    def data(start):
        for i in range(start, 2):
            yield {"tokens": t(inp["dp_tokens/minicpm_2b"][i][rows])}

    with SH.use_mesh(mesh):
        small, state, info = fault.run_resilient(
            plain, small, state, data, 2, str(inp["ckpt_dir"]), ckpt_every=1,
            fail_at=1)
    out["ckpt_restarts"] = np.asarray(info["restarts"])
    out["ckpt_embed"] = _whole(SH, small, "embed", small.embed)
    return out


# -- the four remaining families across ranks -----------------------------------

#: the tensor-parallel forward, prefill and decode of the hybrid (zamba2),
#: MLA MoE (deepseek-v2), audio (whisper) and ssm (rwkv6) families at
#: their reduced configs: rwkv6's has 2 heads, so it runs on (2, 2)
FAM_ARCHS = ("zamba2_2p7b", "deepseek_v2_236b", "whisper_medium",
             "rwkv6_7b")
FAM_RUNS = [(a, "22" if a == "rwkv6_7b" else "14") for a in FAM_ARCHS]
FAM_B, FAM_S, FAM_STEPS = 4, 16, 3
#: deepseek-v2's moe_ffn_a2a alone: reduced (8 experts, top-2, 1 shared
#: expert) at capacity factor 1.25, on (1, 4) and (2, 2)
DS_ARCH, DS_MESHES = "deepseek_v2_236b", ("14", "22")
#: the batcher on a rank: a stream of 5 requests through 2 slots (slots
#: reused) of zamba2 on (1, 4), and of an rwkv6 of 4 heads (d_model 128:
#: the reduced config's 2 heads do not split over 4 ranks) on (1, 4)
SERVE_STREAM = [(0, [3, 9, 4], 3), (0, [7, 1], 4), (1, [5, 5, 2, 8], 2),
                (2, [6], 3), (2, [2, 4, 6, 1, 3], 2)]


def serve_config(arch: str, get_config):
    """The config of the batcher job: rwkv6 widened to 4 heads."""
    import dataclasses
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, d_model=128) if arch == "rwkv6_7b" \
        else cfg


def family_inputs() -> dict:
    """The reference's weights (``init_params`` at PRNGKey(0), deepseek-v2's
    ``init_moe`` at PRNGKey(4)), seeded tokens, whisper's frames and
    deepseek-v2's MoE activations."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models import moe as rM
    from repro.models import transformer as rT
    rng = np.random.default_rng(13)
    out = {}
    for arch in FAM_ARCHS:
        cfg = get_config(arch).reduced()
        out.update(flat_tree(jax.tree.map(np.asarray, rT.init_params(
            cfg, jax.random.PRNGKey(0))), f"w/{arch}"))
        out[f"tok/{arch}"] = rng.integers(0, cfg.vocab, (FAM_B, FAM_S)) \
            .astype(np.int32)
        if cfg.enc_layers:
            out[f"frames/{arch}"] = rng.standard_normal(
                (FAM_B, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    cfg = get_config(DS_ARCH).reduced()
    out.update(flat_tree(jax.tree.map(np.asarray, rM.init_moe(
        jax.random.PRNGKey(4), cfg, jnp.float32)), "moe"))
    out["moe_x"] = rng.standard_normal((MOE_B, MOE_S, cfg.d_model)) \
        .astype(np.float32)
    return out


def ref_families(inp: dict) -> dict:
    """The JAX package under ``shardings.use_mesh`` of each `FAM_RUNS`
    mesh on 4 fake devices: the forward (whisper with its frames), a
    prefill of FAM_S − FAM_STEPS tokens and FAM_STEPS teacher-forced
    decode steps.  The hybrid and ssm families prefill through
    ``decode_step`` one token at a time (the reference's one-forward
    prefill reads only token 0's state inputs on them, ``ROADMAP.md``
    queue 3); whisper prefills with its frames.  Then deepseek-v2's
    ``moe_ffn_a2a`` on each `DS_MESHES` mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models import moe as rM
    from repro.models import shardings as rSH
    from repro.models import transformer as rT
    from repro.serve import serve_step as rS
    out = {}
    p0 = FAM_S - FAM_STEPS
    for arch, name in FAM_RUNS:
        cfg = get_config(arch).reduced()
        params = jax.tree.map(jnp.asarray, nest_tree(inp, f"w/{arch}"))
        toks = jnp.asarray(inp[f"tok/{arch}"])
        kw = ({"enc_frames": jnp.asarray(inp[f"frames/{arch}"])}
              if cfg.enc_layers else {})
        dec = jax.jit(lambda p, t, c, pos: rS.decode_step(p, cfg, t, c,
                                                          pos))
        with rSH.use_mesh(_jax_mesh(TP_MESHES[name])):
            out[f"fwd/{arch}/{name}"] = np.asarray(jax.jit(
                lambda p, t, kw: rT.forward(p, cfg, t, **kw)[0])(
                    params, toks, kw))
            caches = rT.init_caches(cfg, FAM_B, FAM_S)
            if cfg.family in ("hybrid", "ssm"):
                for i in range(p0):
                    lg, caches = dec(params, toks[:, i:i + 1], caches,
                                     jnp.int32(i))
            else:
                lg, caches = jax.jit(
                    lambda p, t, c, kw: rS.prefill_step(p, cfg, t, c, **kw))(
                        params, toks[:, :p0], caches, kw)
            steps = [lg]
            for i in range(FAM_STEPS):
                lg, caches = dec(params, toks[:, p0 + i:p0 + i + 1], caches,
                                 jnp.int32(p0 + i))
                steps.append(lg)
            out[f"dec/{arch}/{name}"] = np.stack(
                [np.asarray(a) for a in steps], 1)
    cfg = get_config(DS_ARCH).reduced()
    p = jax.tree.map(jnp.asarray, nest_tree(inp, "moe"))
    ffn = jax.jit(lambda p, x: rM.moe_ffn_a2a(p, x, cfg))
    for name in DS_MESHES:
        with rSH.use_mesh(_jax_mesh(TP_MESHES[name])):
            out[f"a2a/{name}"] = np.asarray(ffn(p, inp["moe_x"]))
    out["moe_ffn"] = np.asarray(rM.moe_ffn(p, jnp.asarray(inp["moe_x"]),
                                           cfg))
    return out


def _serve_on_rank(torch, T, SH, B, cfg, mesh, dev) -> dict:
    """`SERVE_STREAM` through the batcher with 2 slots on ``mesh`` and
    without a mesh (the rank's whole model, seed 2): tokens and each
    request's prefill logits.  On the mesh, slot 0's position-free state
    is set to 7 before every prefill into it, which the batcher's reset
    must undo for the two runs to agree."""
    out = {}
    for key, m in (("mesh", mesh), ("none", None)):
        model = T.init_params(cfg, 2, device=dev, mesh=m)
        real = B.ContinuousBatcher._slot_view

        def poisoned(self, s, real=real):
            view = real(self, s)
            if s == 0 and self.mesh is not None:
                for name in B.UNPOSITIONED:
                    if name in view:
                        view[name].fill_(7.0)
            return view

        B.ContinuousBatcher._slot_view = poisoned
        try:
            reqs = B.serve_stream(model, cfg, SERVE_STREAM, batch_slots=2,
                                  max_len=16, mesh=m)
        finally:
            B.ContinuousBatcher._slot_view = real
        out[f"{key}/tokens"] = np.asarray([t for r in reqs for t in r.out])
        out[f"{key}/logits"] = torch.stack([r.logits for r in reqs]) \
            .cpu().numpy()
    return out


def rank_families(rank: int, world: int, inp: dict, dev: str) -> dict:
    """The port's side of `ref_families`, each rank on its rows, with the
    collectives of one forward and the caches' shapes; deepseek-v2's
    ``moe_ffn_a2a``; the batcher on a rank (`_serve_on_rank`); and the
    sharded init of each family against the unsharded model's blocks."""
    import torch
    from repro_torch import obs
    from repro_torch.configs.base import get_config
    from repro_torch.core.mesh import ALL_GATHER, ALL_REDUCE, ALL_TO_ALL, Mesh
    from repro_torch.models import moe as M
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import ParamTree
    from repro_torch.models.weights import params_from_jax
    from repro_torch.serve import batching as B
    from repro_torch.serve.serve_step import decode_step, prefill_step
    meshes = {name: Mesh.world(("data", "model"), shape, device=dev)
              for name, shape in TP_MESHES.items()}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = {}
    counts = (ALL_REDUCE, ALL_GATHER, ALL_TO_ALL)
    p0 = FAM_S - FAM_STEPS
    for arch, name in FAM_RUNS:
        cfg = get_config(arch).reduced()
        mesh = meshes[name]
        rows = _rows(mesh, FAM_B)
        model = params_from_jax(nest_tree(inp, f"w/{arch}"), cfg,
                                device=dev, mesh=mesh)
        toks = t(inp[f"tok/{arch}"][rows])
        frames = (t(inp[f"frames/{arch}"][rows]) if cfg.enc_layers
                  else None)
        with torch.no_grad(), SH.use_mesh(mesh):
            before = {c: obs.metrics.get(c) for c in counts}
            out[f"fwd/{arch}/{name}"] = T.forward(
                model, cfg, toks, enc_frames=frames)[0].cpu().numpy()
            out[f"calls/{arch}/{name}"] = np.asarray(
                [obs.metrics.get(c) - before[c] for c in counts])
            caches = T.init_caches(cfg, FAM_B, FAM_S, device=dev, mesh=mesh)
            steps = [prefill_step(model, cfg, toks[:, :p0], caches,
                                  enc_frames=frames)[0]]
            for i in range(FAM_STEPS):
                steps.append(decode_step(model, cfg,
                                         toks[:, p0 + i:p0 + i + 1], caches,
                                         p0 + i)[0])
            out[f"dec/{arch}/{name}"] = torch.stack(steps, 1).cpu().numpy()
        for key, c in leaves(caches):
            out[f"cache/{arch}/{key}"] = np.asarray(c.shape)
    cfg = get_config(DS_ARCH).reduced()
    whole = {k: t(v) for k, v in nest_tree(inp, "moe").items()}
    for name in DS_MESHES:
        mesh = meshes[name]
        p = ParamTree({k: SH.tp_block(f"moe.{k}", v, cfg, mesh)
                       for k, v in whole.items()})
        with torch.no_grad(), SH.use_mesh(mesh):
            out[f"a2a/{name}"] = M.moe_ffn_a2a(
                p, t(inp["moe_x"][_rows(mesh, MOE_B)]), cfg).cpu().numpy()
    for arch in ("zamba2_2p7b", "rwkv6_7b"):
        cfg = serve_config(arch, get_config)
        with torch.no_grad():
            for key, a in _serve_on_rank(torch, T, SH, B, cfg, meshes["14"],
                                         dev).items():
                out[f"serve/{arch}/{key}"] = a
    for arch, name in FAM_RUNS:
        cfg = get_config(arch).reduced()
        mesh = meshes[name]
        full = T.init_params(cfg, 5, device=dev)
        out[f"init_equal/{arch}"] = np.asarray(all(
            torch.equal(q, SH.rank_block(n, full.get_parameter(n), cfg,
                                         mesh))
            for n, q in T.init_params(cfg, 5, device=dev, mesh=mesh)
            .named_parameters()))
    return out


def leaves(tree, prefix=""):
    """(``a/b`` key, leaf) pairs of a nested dict of tensors."""
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, key)
        else:
            yield key, v


# -- the data axis: FSDP, tensor-parallel training, context parallelism --------

#: loss and every leaf's gradient on (data 2, model 2): dense and tied,
#: MoE through ``moe_ffn_a2a``, the hybrid's chunked scan and
#: ``tp_rmsnorm``, rwkv6's 2 heads over model = 2 (gathered receptance)
GRAD_ARCHS = ("minicpm_2b", "llama4_scout_17b_a16e", "zamba2_2p7b",
              "rwkv6_7b")
GRAD_MESH, GRAD_B, GRAD_S = "22", 2, 16
#: two whole int8-compressed steps on (2, 2)
STEP_ARCHS, STEP_N = ("minicpm_2b", "llama4_scout_17b_a16e"), 2
#: context-parallel prefill + decode at B = 1, per arch (max_len, prompt):
#: gemma2's window of 32 crosses the ranks' boundaries (16 positions per
#: rank on (4, 1)), zamba2's and whisper's O(1) states and cross caches
#: beside the split ``attn.k/v`` and ``k``/``v``
CP_RUNS = {"minicpm_2b": (64, 36), "deepseek_v2_236b": (64, 36),
           "zamba2_2p7b": (16, 12), "whisper_medium": (64, 36),
           "gemma2_9b": (64, 40)}
CP_MESHES, CP_STEPS = ("41", "22"), 4


def data_inputs() -> dict:
    """The weights of every arch the data jobs run, as the reference's
    pytree (the port's ``init_params`` at seed 0 read by
    ``weights.reference_tree``: drawn in milliseconds, where the
    reference's eager init takes seconds per arch), and their seeded
    tokens and frames."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import reference_tree
    rng = np.random.default_rng(17)
    out = {}
    for arch in sorted(set(GRAD_ARCHS) | set(STEP_ARCHS) | set(CP_RUNS)):
        cfg = get_config(arch).reduced()
        out.update(flat_tree(reference_tree(T.init_params(
            cfg, 0, device="cpu")), f"w/{arch}"))
        if arch in GRAD_ARCHS:
            out[f"g_tokens/{arch}"] = rng.integers(
                0, cfg.vocab, (GRAD_B, GRAD_S + 1)).astype(np.int32)
        if arch in STEP_ARCHS:
            out[f"s_tokens/{arch}"] = rng.integers(
                0, cfg.vocab, (STEP_N, GRAD_B, GRAD_S + 1)).astype(np.int32)
        if arch in CP_RUNS:
            out[f"cp_tokens/{arch}"] = rng.integers(
                0, cfg.vocab, (1, CP_RUNS[arch][1] + CP_STEPS)) \
                .astype(np.int32)
            if cfg.enc_layers:
                out[f"cp_frames/{arch}"] = rng.standard_normal(
                    (1, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    return out


#: the reference's side, in three processes that run side by side
REF_DATA = ("ref_data_grads", "ref_data_steps", "ref_data_cp")


def ref_data_grads(inp: dict) -> dict:
    """The JAX package under ``shardings.use_mesh`` of a (2, 2) mesh of
    fake devices: ``jax.value_and_grad(next_token_loss)`` of each
    `GRAD_ARCHS` arch."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models import shardings as rSH
    from repro.train import train_step as rTS
    out = {}
    with rSH.use_mesh(_jax_mesh(TP_MESHES[GRAD_MESH])):
        for arch in GRAD_ARCHS:
            cfg = get_config(arch).reduced()
            params = jax.tree.map(jnp.asarray, nest_tree(inp, f"w/{arch}"))
            loss, grads = jax.jit(jax.value_and_grad(rTS.next_token_loss),
                                  static_argnums=(1, 3))(
                params, cfg, {"tokens": jnp.asarray(inp[f"g_tokens/{arch}"])},
                "full")
            out[f"g/{arch}/loss"] = np.asarray(loss)
            out.update(flat_tree(jax.tree.map(np.asarray, grads),
                                 f"g/{arch}/grad"))
    return out


def ref_data_steps(inp: dict) -> dict:
    """`STEP_N` int8-compressed ``train_step``s of each `STEP_ARCHS` arch
    under a (2, 2) mesh of fake devices."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models import shardings as rSH
    from repro.train import optimizer as rO
    from repro.train import train_step as rTS
    out = {}
    with rSH.use_mesh(_jax_mesh(TP_MESHES[GRAD_MESH])):
        for arch in STEP_ARCHS:
            cfg = get_config(arch).reduced()
            params = jax.tree.map(jnp.asarray, nest_tree(inp, f"w/{arch}"))
            opt = rTS.init_opt_state(params, True)
            step = jax.jit(rTS.make_train_step(
                cfg, rO.OptConfig(**DP_OPT), remat="full",
                grad_compress=True))
            losses = []
            for i in range(STEP_N):
                params, opt, metrics = step(params, opt, {
                    "tokens": jnp.asarray(inp[f"s_tokens/{arch}"][i])})
                losses.append(float(metrics["loss"]))
            out[f"s/{arch}/loss"] = np.asarray(losses)
            out.update(flat_tree(jax.tree.map(np.asarray, params),
                                 f"s/{arch}/ref"))
    return out


def ref_data_cp(inp: dict) -> dict:
    """Each `CP_RUNS` arch's prefill (the hybrid's through ``decode_step``
    token by token) and `CP_STEPS` teacher-forced decode steps at B = 1,
    under each `CP_MESHES` mesh of fake devices."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models import shardings as rSH
    from repro.models import transformer as rT
    from repro.serve import serve_step as rS
    out = {}
    for arch, (max_len, p0) in CP_RUNS.items():
        cfg = get_config(arch).reduced()
        params = jax.tree.map(jnp.asarray, nest_tree(inp, f"w/{arch}"))
        toks = jnp.asarray(inp[f"cp_tokens/{arch}"])
        kw = ({"enc_frames": jnp.asarray(inp[f"cp_frames/{arch}"])}
              if cfg.enc_layers else {})
        for name in CP_MESHES:
            with rSH.use_mesh(_jax_mesh(TP_MESHES[name])):
                dec = jax.jit(lambda p, t, c, pos: rS.decode_step(
                    p, cfg, t, c, pos))
                caches = rT.init_caches(cfg, 1, max_len)
                if cfg.family == "hybrid":
                    for i in range(p0):
                        lg, caches = dec(params, toks[:, i:i + 1], caches,
                                         jnp.int32(i))
                else:
                    lg, caches = jax.jit(lambda p, t, c, kw: rS.prefill_step(
                        p, cfg, t, c, **kw))(params, toks[:, :p0], caches,
                                             kw)
                steps = [lg]
                for i in range(CP_STEPS):
                    lg, caches = dec(params, toks[:, p0 + i:p0 + i + 1],
                                     caches, jnp.int32(p0 + i))
                    steps.append(lg)
            out[f"cp/{arch}/{name}"] = np.stack([np.asarray(a)
                                                 for a in steps], 1)
    return out


def rank_data(rank: int, world: int, inp: dict, dev: str) -> dict:
    """The port's side of `REF_DATA`.  On (2, 2), from the same
    weights, each rank on its row of the batch: the loss and every
    gradient (``g/``, reassembled whole from the ranks' blocks) and each
    rank's own blocks of the parameters and gradients (``gl/``, ``pl/``,
    to hold the replicated ones bit for bit equal and the sharded ones
    at 1/(D·M)); `STEP_N` int8-compressed steps (the parameters and
    their rounding ties whole); a checkpoint of the trained llama4-scout
    saved on (2, 2) and restored on (4, 1) and without a mesh (``ck/``:
    the whole leaves read back equal).  Then each `CP_RUNS` arch at B = 1
    on each `CP_MESHES` mesh: the prefill (token by token on the
    hybrid), `CP_STEPS` decode steps, and the caches' per-rank shapes."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import params_from_jax, whole_tensors
    from repro_torch.serve.serve_step import decode_step, prefill_step
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig
    meshes = {name: Mesh.world(("data", "model"), TP_MESHES[name],
                               device=dev) for name in ("22", "41")}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = {}
    mesh = meshes[GRAD_MESH]
    rows = _rows(mesh, GRAD_B)
    for arch in GRAD_ARCHS:
        cfg = get_config(arch).reduced()
        model = params_from_jax(nest_tree(inp, f"w/{arch}"), cfg,
                                device=dev, mesh=mesh).requires_grad_(True)
        with SH.use_mesh(mesh):
            loss = TS.next_token_loss(model, cfg, {
                "tokens": t(inp[f"g_tokens/{arch}"][rows])}, "full")
            loss.backward()
            loss = TS.average_over_data(model, loss, mesh)
        out[f"g/{arch}/loss"] = loss.detach().cpu().numpy()
        grads = whole_tensors(model, {n: q.grad for n, q in
                                      model.named_parameters()})
        for n, q in model.named_parameters():
            out[f"g/{arch}/grad/{n}"] = grads[n].cpu().numpy()
            out[f"gl/{arch}/{n}"] = q.grad.cpu().numpy()
            out[f"pl/{arch}/{n}"] = q.detach().cpu().numpy()
    ties, real = {}, TS._compress_group
    for arch in STEP_ARCHS:
        cfg = get_config(arch).reduced()
        model = params_from_jax(nest_tree(inp, f"w/{arch}"), cfg,
                                device=dev, mesh=mesh)
        opt = TS.init_opt_state(model, grad_compress=True)
        step = TS.make_train_step(cfg, OptConfig(**DP_OPT), remat="full",
                                  grad_compress=True)
        ties.clear()

        def recording(gs, errs):
            names = {id(q.grad): n for n, q in model.named_parameters()}
            ties.update(tie_records(torch, [names[id(a)] for a in gs], gs,
                                    errs, ties, TS.group_amax))
            return real(gs, errs)

        TS._compress_group = recording
        losses = []
        try:
            with SH.use_mesh(mesh):
                for i in range(STEP_N):
                    model, opt, metrics = step(model, opt, {
                        "tokens": t(inp[f"s_tokens/{arch}"][i][rows])})
                    losses.append(float(metrics["loss"]))
        finally:
            TS._compress_group = real
        out[f"s/{arch}/loss"] = np.asarray(losses)
        for n, q in model.named_parameters():
            out[f"s/{arch}/p/{n}"] = _whole(SH, model, n, q)
            out[f"s/{arch}/tie/{n}"] = _whole(SH, model, n, torch.from_numpy(
                ties[n]).float().to(dev)) > 0.5
    # elastic checkpoints: saved on (2, 2), restored on (4, 1) and alone
    ckdir = str(inp["ckpt_dir"])
    CK.save(ckdir, 1, (model, opt), write=mesh.rank == 0)
    mesh.agree(True)

    def whole_state(m, st):
        return {f"{kind}/{n}": _whole(SH, m, n, src[n]) for kind, src in
                (("p", dict(m.named_parameters())), ("mu", st["mu"]),
                 ("nu", st["nu"]), ("err", st["err"]))
                for n, _ in m.named_parameters()}

    saved = whole_state(model, opt)
    for name, m in (("41", meshes["41"]), ("none", None)):
        other = params_from_jax(nest_tree(inp, f"w/{arch}"), cfg,
                                device=dev, mesh=m)
        st = TS.init_opt_state(other, grad_compress=True)
        CK.restore(ckdir, (other, st))
        # the rank's blocks of the saved leaves (no collective)
        got = {f"{kind}/{n}": src[n].detach().cpu().numpy() for kind, src in
               (("p", dict(other.named_parameters())), ("mu", st["mu"]),
                ("nu", st["nu"]), ("err", st["err"]))
               for n, _ in other.named_parameters()}
        want = {k: SH.rank_block(k.partition("/")[2], torch.from_numpy(a),
                                 cfg, m).numpy() for k, a in saved.items()}
        out[f"ck/{name}"] = np.asarray(
            got.keys() == want.keys()
            and all(np.array_equal(got[k], want[k]) for k in want)
            and int(st["step"]) == int(opt["step"]))
    # context parallelism at B = 1
    with torch.no_grad():
        for arch, (max_len, p0) in CP_RUNS.items():
            cfg = get_config(arch).reduced()
            toks = t(inp[f"cp_tokens/{arch}"])
            frames = (t(inp[f"cp_frames/{arch}"]) if cfg.enc_layers
                      else None)
            for name in CP_MESHES:
                m = meshes[name]
                model = params_from_jax(nest_tree(inp, f"w/{arch}"), cfg,
                                        device=dev, mesh=m)
                with SH.use_mesh(m):
                    caches = T.init_caches(cfg, 1, max_len, device=dev,
                                           mesh=m)
                    steps = [prefill_step(model, cfg, toks[:, :p0], caches,
                                          enc_frames=frames)[0]]
                    for i in range(CP_STEPS):
                        steps.append(decode_step(
                            model, cfg, toks[:, p0 + i:p0 + i + 1], caches,
                            p0 + i)[0])
                out[f"cp/{arch}/{name}"] = torch.stack(steps, 1) \
                    .cpu().numpy()
                for key, c in leaves(caches):
                    out[f"cpc/{arch}/{name}/{key}"] = np.asarray(c.shape)
    return out


# -- the analysis' replication check and the dry run's collective counts ------

#: registry entries whose replication claim the 4 ranks check
SPMD_ENTRIES = ("dist/parhip_round", "dist/parhyp_round",
                "dist/parhyp_round_2d", "dist/cluster_round",
                "dist/contract", "memetic/migrate_ring")
#: (arch, mesh, what) runs whose collectives the dry run's stand-in counts:
#: one forward of B = 2, L = 16 tokens, or one train step on that batch
COUNT_RUNS = (("minicpm_2b", (1, 4), "fwd"),
              ("llama4_scout_17b_a16e", (2, 2), "fwd"),
              ("zamba2_2p7b", (1, 4), "fwd"),
              ("deepseek_v2_236b", (1, 4), "fwd"),
              ("gemma2_9b", (2, 2), "train"))
COUNT_B, COUNT_L = 2, 16


def phi_entry(reduce_phi: bool):
    """A miniature parhyp Φ round as a registry entry: each rank counts
    its shard's pins per (net, block) and, with ``reduce_phi``, psums the
    partials over ``nets``; the histogram is claimed replicated."""
    import torch
    from repro_torch.analysis.registry import EntryPoint
    from repro_torch.core.mesh import Mesh

    def build(device, mesh=None):
        mesh = mesh if mesh is not None else Mesh.local(("nets",), device)
        me = mesh.axis_index("nets")
        pe = torch.arange(8, device=mesh.device) % 4
        pv = (torch.arange(8, device=mesh.device) + me) % 16
        labels = torch.arange(16, device=mesh.device) % 2

        def fn(pe, pv, labels):
            cnt = torch.zeros(4 * 2, device=mesh.device).index_add_(
                0, pe * 2 + labels[pv], torch.ones(8, device=mesh.device))
            if reduce_phi:
                cnt = mesh.psum(cnt, "nets")
            return cnt.view(4, 2)
        return fn, (pe, pv, labels)

    return EntryPoint(name=f"fixture/phi_{reduce_phi}", build=build,
                      tags=frozenset({"spmd"}), mesh_axes=("nets",),
                      replicated=lambda out: {"phi": out})


def count_inputs(torch, cfg, rows: int, dev):
    gen = torch.Generator(device=dev).manual_seed(26)
    return torch.randint(0, cfg.vocab, (rows, COUNT_L + 1), generator=gen,
                         device=dev)


def count_run(torch, cfg, model, what: str, toks):
    """The run of a `COUNT_RUNS` entry on ``model`` under the current
    mesh."""
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_opt_state, make_train_step
    if what == "fwd":
        with torch.no_grad():
            T.forward(model, cfg, toks[:, :-1])
        return
    make_train_step(cfg, OptConfig(), remat="full")(
        model, init_opt_state(model), {"tokens": toks})


def rank_spmd(rank: int, world: int, inp: dict, dev: str) -> dict:
    """`analysis.spmd.check_spmd` of every `SPMD_ENTRIES` entry on its
    mesh of the 4 ranks, and of `phi_entry` with and without its psum:
    the finding codes and the axes they name."""
    from repro_torch.analysis import registry as REG
    from repro_torch.analysis import spmd
    from repro_torch.core.mesh import Mesh
    meshes = {("nodes",): Mesh.world(("nodes",), device=dev),
              ("nets",): Mesh.world(("nets",), device=dev),
              ("islands",): Mesh.world(("islands",), device=dev),
              ("nets", "verts"): Mesh.world(("nets", "verts"), (2, 2),
                                            device=dev)}
    reg = REG.default_registry()
    out = {}
    entries = [reg[n] for n in SPMD_ENTRIES] + [phi_entry(True),
                                                 phi_entry(False)]
    for e in entries:
        found = spmd.check_spmd(e, meshes[e.mesh_axes])
        out[f"spmd/{e.name}"] = np.asarray([f.code for f in found], str)
        out[f"axes/{e.name}"] = np.asarray(
            [a for f in found for a in f.detail["varying"]], str)
    return out


def rank_counts(rank: int, world: int, inp: dict, dev: str) -> dict:
    """The mesh/* calls (all-reduce, all-gather, reduce-scatter,
    all-to-all) of each `COUNT_RUNS` run on this rank."""
    import torch
    from repro_torch import obs
    from repro_torch.configs.base import get_config
    from repro_torch.core.mesh import (ALL_GATHER, ALL_REDUCE, ALL_TO_ALL,
                                       REDUCE_SCATTER, Mesh)
    from repro_torch.launch.dryrun import rank_rows
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    kinds = (ALL_REDUCE, ALL_GATHER, REDUCE_SCATTER, ALL_TO_ALL)
    out = {}
    for arch, shape, what in COUNT_RUNS:
        cfg = get_config(arch).reduced()
        mesh = Mesh.world(("data", "model"), shape, device=dev)
        model = T.init_params(cfg, 0, mesh=mesh)
        rows = rank_rows(mesh, COUNT_B)
        toks = count_inputs(torch, cfg, COUNT_B, dev)
        toks = toks[rows * mesh.axis_index("data"):][:rows]
        with SH.use_mesh(mesh):
            before = {k: obs.metrics.get(k) for k in kinds}
            count_run(torch, cfg, model, what, toks)
            out[f"calls/{arch}/{what}"] = np.asarray(
                [obs.metrics.get(k) - before[k] for k in kinds])
    return out


# -- the port on 4 cards against its 4 CPU ranks --------------------------------

JOBS = ("rank_parhip", "rank_parhyp", "rank_memetic", "rank_stack",
        "rank_data")
# outputs no generator draw feeds: bit for bit the CPU ranks'
EXACT = {"rank_parhip": ("labels",),
         "rank_parhyp": ("draws4", "draws41", "draws14", "levels",
                         "n_coarse"),
         "rank_memetic": ("roll4", "roll6", "roll8", "ppermutes4",
                          "ppermutes6", "ppermutes8"),
         "rank_stack": ("kv/", "calls/", "placed_", "ckpt_restarts",
                        "probe_", "init_equal"),
         "rank_data": ("cpc/", "ck/", "pl/")}
# float outputs of the stack job: within 1e-4 of the CPU ranks' max |x|
# (other summation orders on the card), the trained parameters within 1e-5
# of their max |p| outside either run's int8 rounding ties
CLOSE = {"rank_stack": ("fwd/", "dec/", "a2a", "ckpt_embed")}
LEVEL_FIELDS = ("pv", "pe", "mask", "netw", "esize", "vwgt", "coarse_of")


def expect(d: Path) -> None:
    """The inputs and the 4 gloo ranks' outputs of every job, under d."""
    (d / "cpu").mkdir(parents=True, exist_ok=True)
    shutil.rmtree(d / "cpu" / "ckpt", ignore_errors=True)
    shutil.rmtree(d / "cpu" / "data-ckpt", ignore_errors=True)
    from repro_torch.core.hypergraph.dist import shard_hypergraph
    from repro_torch.core.parhip import shard_graph
    from repro_torch.io.generators import grid2d, planted_hypergraph
    inputs = {"rank_parhip": dict(noise=parhip_noise(
                  shard_graph(grid2d(*GRID), 4).rows, 4)),
              "rank_parhyp": dict(noise=parhyp_noise(
                  shard_hypergraph(planted_hypergraph(**HG), 1).n_pad, 4)),
              "rank_memetic": {},
              "rank_stack": dict(stack_inputs(),
                                 ckpt_dir=str(d / "cpu" / "ckpt")),
              "rank_data": dict(data_inputs(),
                                ckpt_dir=str(d / "cpu" / "data-ckpt"))}
    for job in JOBS:
        run_ranks(job, 4, d / "cpu", **inputs[job])


def stack_local(job: str, key: str) -> bool:
    """Outputs of the stack and data jobs that are a rank's own: its rows
    of the batch, its experts, its KV heads, its blocks of the parameters
    and gradients (the rest is replicated)."""
    if job == "rank_data":
        return key.startswith(("gl/", "pl/"))
    if job != "rank_stack":
        return False
    return key.startswith(("fwd/", "dec/", "kv/", "a2a", "placed_w_gate",
                           "probe_")) or (key.startswith("dp/")
                                          and "/tie/" in key)


def stack_close(cpu: dict, got: dict) -> list:
    """The stack job's float outputs on a card against the CPU rank's."""
    bad = []
    for key, want in cpu.items():
        if key.startswith(CLOSE["rank_stack"]) or (
                key.startswith("dp/") and key.endswith("/loss")):
            err = float(np.abs(got[key] - want).max())
            if err > 1e-4 * float(np.abs(want).max()):
                bad.append(f"rank_stack: {key} off by {err:g}")
        elif key.startswith("dp/") and "/p/" in key:
            keep = ~(cpu[key.replace("/p/", "/tie/")]
                     | got[key.replace("/p/", "/tie/")])
            err = float(np.abs(got[key] - want)[keep].max(initial=0.0))
            if err > 1e-5 * float(np.abs(want).max()):
                bad.append(f"rank_stack: {key} off by {err:g}")
    return bad


def data_close(cpu: dict, got: dict) -> list:
    """The data job's float outputs on a card against the CPU rank's: the
    logits, losses and gradients within 1e-4 of max |x| (a gradient
    leaf below 1e-6 of its arch's largest is zero in exact arithmetic:
    it must stay below that bound), the trained parameters within 1e-5
    of max |p| outside either run's int8 rounding ties."""
    bad = []
    top = {}
    for key, want in cpu.items():
        if key.startswith(("g/", "gl/")) and "/loss" not in key:
            arch = key.split("/")[1]
            top[arch] = max(top.get(arch, 0.0), float(np.abs(want).max()))
    for key, want in cpu.items():
        if key.startswith(("cp/", "g/", "gl/")) or key.endswith("/loss"):
            scale = float(np.abs(want).max())
            floor = 1e-6 * top.get(key.split("/")[1], 0.0)
            err = float(np.abs(got[key] - want).max())
            if (scale <= floor and float(np.abs(got[key]).max()) > floor) \
                    or (scale > floor and err > 1e-4 * scale):
                bad.append(f"rank_data: {key} off by {err:g}")
        elif key.startswith("s/") and "/p/" in key:
            keep = ~(cpu[key.replace("/p/", "/tie/")]
                     | got[key.replace("/p/", "/tie/")])
            err = float(np.abs(got[key] - want)[keep].max(initial=0.0))
            if err > 1e-5 * float(np.abs(want).max()):
                bad.append(f"rank_data: {key} off by {err:g}")
    return bad


def _contracts(job: str, ranks: list) -> list:
    """The failures of the contracts that hold whatever the draws: every
    output but a rank's own shard (pv, pe, mask of a level) replicated."""
    bad = [f"{job}: {key} differs between ranks"
           for out in ranks[1:] for key in out
           if key.rstrip("0123456789") not in ("pv", "pe", "mask")
           and not stack_local(job, key)
           and not np.array_equal(out[key], ranks[0][key])]
    out = ranks[0]
    if job == "rank_parhip" and not bool(out["feasible"]):
        bad.append("parhip infeasible")
    if job == "rank_parhyp":
        if not (np.array_equal(out["gen4"], out["gen41"])
                and np.array_equal(out["gen4"], out["gen14"])):
            bad.append("parhyp layouts differ on the generator")
        if not bool(out["feasible22"]) or int(out["device_levels22"]) < 2:
            bad.append("parhyp (2, 2) infeasible or not coarsened")
    if job == "rank_stack" and int(out["ckpt_restarts"]) != 1:
        bad.append("the checkpointed run did not restart once")
    if job == "rank_data" and not all(bool(o[k]) for o in ranks
                                      for k in o if k.startswith("ck/")):
        bad.append("a checkpoint saved on (2, 2) restored other leaves")
    if job == "rank_memetic":
        if not np.array_equal(out["kaffpaE_mesh"], out["kaffpaE_none"]):
            bad.append("kaffpaE over the mesh differs from mesh=None")
        if not (bool(out["kahyparE_feasible"])
                and int(out["kahyparE_km1"]) <= int(out["kahypar_km1"])):
            bad.append("kahyparE infeasible or above member 0")
    return bad


def cuda_check(d: Path) -> int:
    bad, exact = [], 0
    for job in JOBS:
        cpu = [dict(np.load(d / "cpu" / f"{job}-{r}.npz")) for r in range(4)]
        inputs = dict(np.load(d / "cpu" / f"{job}-inputs.npz"))
        if "ckpt_dir" in inputs:          # a fresh one: no earlier steps
            inputs["ckpt_dir"] = str(d / f"{job}-ckpt")
            shutil.rmtree(inputs["ckpt_dir"], ignore_errors=True)
        ranks = run_ranks(job, 4, d, device="cuda", **inputs)
        bad += _contracts(job, ranks)
        if job == "rank_stack":
            for r in range(4):
                bad += stack_close(cpu[r], ranks[r])
        if job == "rank_data":
            for r in range(4):
                bad += data_close(cpu[r], ranks[r])
        keys = list(EXACT[job])
        if job == "rank_parhyp":
            keys += [f"{f}{i}" for i in range(int(cpu[0]["levels"]))
                     for f in LEVEL_FIELDS if f"{f}{i}" in cpu[0]]
        if job in ("rank_stack", "rank_data"):
            keys = [k for k in cpu[0] if k.startswith(tuple(keys))]
        for r in range(4):
            for key in keys:
                exact += 1
                if not np.array_equal(ranks[r].get(key), cpu[r][key]):
                    bad.append(f"{job}: rank {r} {key} != the CPU rank's")
    print(json.dumps({"ok": not bad, "exact_arrays": exact,
                      "failures": bad}))
    return 1 if bad else 0


def main(argv) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    job, out = argv[0], argv[1]
    if job == "expect":
        expect(Path(out))
        return 0
    if job == "cuda-check":
        return cuda_check(Path(out))
    if job.startswith("ref_"):
        args = [dict(np.load(argv[2]))] if len(argv) > 2 else []
        np.savez(out, **globals()[job](*args))
        return 0
    import torch.distributed as dist
    from repro_torch.launch.ranks import join
    rank, world, store = int(argv[2]), int(argv[3]), argv[4]
    inp = dict(np.load(argv[5]))
    dev = join(rank, world, store, argv[6])
    try:
        np.savez(out, **globals()[job](rank, world, inp, dev))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
