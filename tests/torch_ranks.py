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
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 180            # seconds, per process

# parhip: grid2d(32, 32), k = 4; parhyp: planted_hypergraph(300, 450), k = 4
GRID = (32, 32)
HG = dict(n=300, m=450, blocks=4, seed=7)
K = 4
ROUNDS = 6
SEED = 3


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", NCCL_SOCKET_IFNAME="lo")
    env.update(extra)
    return env


def run_ranks(job: str, world: int, tmp: Path, device: str = "cpu",
              **inputs) -> list:
    """Run ``job`` on ``world`` ranks (``device`` ``cpu``: gloo, ``cuda``:
    NCCL, one card each) with the arrays ``inputs``; returns each rank's
    arrays."""
    tmp = tmp.resolve()
    store, inp = tmp / f"{job}.store", tmp / f"{job}-inputs.npz"
    store.unlink(missing_ok=True)
    np.savez(inp, **inputs)
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(tmp / f"{job}-{r}.npz"), str(r),
         str(world), str(store), str(inp), device], env=_env(),
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"{job} rank {r} exited {p.returncode}:\n"
                                 f"{logs[r]}")
    return [dict(np.load(tmp / f"{job}-{r}.npz")) for r in range(world)]


def run_reference(job: str, devices: int, tmp: Path) -> dict:
    """Run the JAX package's ``job`` on ``devices`` fake host devices."""
    out = tmp / f"{job}.npz"
    r = subprocess.run(
        [sys.executable, __file__, job, str(out)], capture_output=True,
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


# -- the port on 4 cards against its 4 CPU ranks --------------------------------

JOBS = ("rank_parhip", "rank_parhyp", "rank_memetic")
# outputs no generator draw feeds: bit for bit the CPU ranks'
EXACT = {"rank_parhip": ("labels",),
         "rank_parhyp": ("draws4", "draws41", "draws14", "levels",
                         "n_coarse"),
         "rank_memetic": ("roll4", "roll6", "roll8", "ppermutes4",
                          "ppermutes6", "ppermutes8")}
LEVEL_FIELDS = ("pv", "pe", "mask", "netw", "esize", "vwgt", "coarse_of")


def expect(d: Path) -> None:
    """The inputs and the 4 gloo ranks' outputs of every job, under d."""
    (d / "cpu").mkdir(parents=True, exist_ok=True)
    from repro_torch.core.hypergraph.dist import shard_hypergraph
    from repro_torch.core.parhip import shard_graph
    from repro_torch.io.generators import grid2d, planted_hypergraph
    inputs = {"rank_parhip": dict(noise=parhip_noise(
                  shard_graph(grid2d(*GRID), 4).rows, 4)),
              "rank_parhyp": dict(noise=parhyp_noise(
                  shard_hypergraph(planted_hypergraph(**HG), 1).n_pad, 4)),
              "rank_memetic": {}}
    for job in JOBS:
        run_ranks(job, 4, d / "cpu", **inputs[job])


def _contracts(job: str, ranks: list) -> list:
    """The failures of the contracts that hold whatever the draws: every
    output but a rank's own shard (pv, pe, mask of a level) replicated."""
    bad = [f"{job}: {key} differs between ranks"
           for out in ranks[1:] for key in out
           if key.rstrip("0123456789") not in ("pv", "pe", "mask")
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
        ranks = run_ranks(job, 4, d, device="cuda",
                          **dict(np.load(d / "cpu" / f"{job}-inputs.npz")))
        bad += _contracts(job, ranks)
        keys = list(EXACT[job])
        if job == "rank_parhyp":
            keys += [f"{f}{i}" for i in range(int(cpu[0]["levels"]))
                     for f in LEVEL_FIELDS if f"{f}{i}" in cpu[0]]
        for r in range(4):
            for key in keys:
                exact += 1
                if not np.array_equal(ranks[r].get(key), cpu[r][key]):
                    bad.append(f"{job}: rank {r} {key} != the CPU rank's")
    print(json.dumps({"ok": not bad, "exact_arrays": exact,
                      "failures": bad}))
    return 1 if bad else 0


def main(argv) -> int:
    job, out = argv[0], argv[1]
    if job == "expect":
        expect(Path(out))
        return 0
    if job == "cuda-check":
        return cuda_check(Path(out))
    if job.startswith("ref_"):
        np.savez(out, **globals()[job]())
        return 0
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store = int(argv[2]), int(argv[3]), argv[4]
    inp = dict(np.load(argv[5]))
    dev = "cpu" if argv[6] == "cpu" else f"cuda:{rank}"
    if dev != "cpu":
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if dev == "cpu" else "nccl",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        np.savez(out, **globals()[job](rank, world, inp, dev))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
