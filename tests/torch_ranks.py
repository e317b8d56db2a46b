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


def tie_records(torch, names, gs, errs, ties) -> dict:
    """The int8 compression's rounding ties, or'ed into ``ties``: per
    parameter name, the elements whose pre-quantization value g / scale
    (one scale over the group, as ``train_step._compress_group`` takes
    it) lies within 5e-4 of a half-integer, where f32 noise may pick the
    other int8 code."""
    g = [a.float() + e for a, e in zip(gs, errs)]
    scale = torch.stack([a.abs().max() for a in g]).max() / 127.0 + 1e-12
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
    injected failure (rank 0 writes, every rank restores)."""
    import torch
    from repro_torch import obs
    from repro_torch.configs.base import get_config
    from repro_torch.core.mesh import ALL_GATHER, ALL_REDUCE, ALL_TO_ALL, Mesh
    from repro_torch.models import moe as M
    from repro_torch.models import shardings as SH
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import ParamTree
    from repro_torch.models.weights import params_from_jax
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
        torch.equal(q, SH.tp_block(n, full.get_parameter(n), cfg, mesh))
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
        model = params_from_jax(nest_tree(inp, f"w/{arch}"), cfg, device=dev)
        opt = TS.init_opt_state(model, grad_compress=True)
        step = TS.make_train_step(cfg, OptConfig(**DP_OPT), remat="full",
                                  grad_compress=True)
        ties.clear()

        def recording(gs, errs):
            names = {id(q.grad): n for n, q in model.named_parameters()}
            ties.update(tie_records(torch, [names[id(a)] for a in gs], gs,
                                    errs, ties))
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
            out[f"dp/{arch}/p/{n}"] = q.detach().cpu().numpy()
            out[f"dp/{arch}/tie/{n}"] = ties[n]
    # checkpoints under the mesh: a failure injected at step 1 of 2
    cfg = stack_config("minicpm_2b", get_config)
    small = T.init_params(cfg, 1, device="cpu").to(dev)
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
    out["ckpt_embed"] = small.embed.detach().cpu().numpy()
    return out


# -- the port on 4 cards against its 4 CPU ranks --------------------------------

JOBS = ("rank_parhip", "rank_parhyp", "rank_memetic", "rank_stack")
# outputs no generator draw feeds: bit for bit the CPU ranks'
EXACT = {"rank_parhip": ("labels",),
         "rank_parhyp": ("draws4", "draws41", "draws14", "levels",
                         "n_coarse"),
         "rank_memetic": ("roll4", "roll6", "roll8", "ppermutes4",
                          "ppermutes6", "ppermutes8"),
         "rank_stack": ("kv/", "calls/", "placed_", "ckpt_restarts",
                        "probe_", "init_equal")}
# float outputs of the stack job: within 1e-4 of the CPU ranks' max |x|
# (other summation orders on the card), the trained parameters within 1e-5
# of their max |p| outside either run's int8 rounding ties
CLOSE = {"rank_stack": ("fwd/", "dec/", "a2a", "ckpt_embed")}
LEVEL_FIELDS = ("pv", "pe", "mask", "netw", "esize", "vwgt", "coarse_of")


def expect(d: Path) -> None:
    """The inputs and the 4 gloo ranks' outputs of every job, under d."""
    (d / "cpu").mkdir(parents=True, exist_ok=True)
    shutil.rmtree(d / "cpu" / "ckpt", ignore_errors=True)
    from repro_torch.core.hypergraph.dist import shard_hypergraph
    from repro_torch.core.parhip import shard_graph
    from repro_torch.io.generators import grid2d, planted_hypergraph
    inputs = {"rank_parhip": dict(noise=parhip_noise(
                  shard_graph(grid2d(*GRID), 4).rows, 4)),
              "rank_parhyp": dict(noise=parhyp_noise(
                  shard_hypergraph(planted_hypergraph(**HG), 1).n_pad, 4)),
              "rank_memetic": {},
              "rank_stack": dict(stack_inputs(),
                                 ckpt_dir=str(d / "cpu" / "ckpt"))}
    for job in JOBS:
        run_ranks(job, 4, d / "cpu", **inputs[job])


def stack_local(job: str, key: str) -> bool:
    """Outputs of the stack job that are a rank's own: its rows of the
    batch, its experts, its KV heads (the rest is replicated)."""
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
        keys = list(EXACT[job])
        if job == "rank_parhyp":
            keys += [f"{f}{i}" for i in range(int(cpu[0]["levels"]))
                     for f in LEVEL_FIELDS if f"{f}{i}" in cpu[0]]
        if job == "rank_stack":
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
