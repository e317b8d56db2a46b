"""Port parity: the memetic engine (`repro_torch.core.memetic`), kaffpaE,
kahyparE and the memetic separator against the JAX package.

The island loop is host numpy in both packages, so on a deterministic
numpy medium that satisfies both packages' `Medium` protocol the two
drivers must produce the same islands, keys, generation count and
``memetic/*`` counters.  The only difference between them is how a sweep
row gets its noise: the reference passes jax keys ``PRNGKey(s) == [0, s]``,
the port the integer ``s`` itself; the stub reads the same ``s`` from
either.  On the real media the port's own contracts are held (islands
evolve independently, batched generations equal sequential ones, member 0
is one single run), and whole runs — which draw from different
generators — are held to the reference's band: the sum over 3 seeds at
most 1.15× the reference's, and never worse than the port's own single
run at the same seed.
"""
import types

import numpy as np
import pytest
import jax
from jax.sharding import Mesh as JMesh

from repro import obs as robs
from repro.core import evolve as rE
from repro.core import hypergraph as rH
from repro.core import kaffpa as rK
from repro.core import memetic as rMEM
from repro.core import nodesep as rNS
from repro.core.memetic import driver as rD
from repro.io import generators as rgen

from repro_torch import obs as tobs
from repro_torch.core import evolve as tE
from repro_torch.core import hypergraph as tH
from repro_torch.core import interface as tif
from repro_torch.core import kaffpa as tK
from repro_torch.core import memetic as tMEM
from repro_torch.core import multilevel as tML
from repro_torch.core import nodesep as tNS
from repro_torch.core.hypergraph import driver as tHD
from repro_torch.core.memetic import driver as tD
from repro_torch.core.memetic.driver import _replace_key
from repro_torch.core.partition import edge_cut, is_feasible
from repro_torch.io import generators as tgen

BAND = 1.15
SEEDS = (1, 2, 3)
GRID = tgen.grid2d(10, 10)


# -- a deterministic numpy medium both packages' engines accept --------------

class StubMedium:
    """A weighted edge list (each undirected edge once) whose every method
    draws from ``np.random.default_rng(seed)``: random matching, label
    contraction, a greedy capped move search, random initial labels."""

    def __init__(self, n, src, dst, w, vwgt, recorder=None):
        self._n, self.src, self.dst, self.w = n, src, dst, w
        self.vwgt = vwgt
        self.recorder = recorder

    @classmethod
    def grid(cls, rows, cols, recorder=None):
        ids = np.arange(rows * cols).reshape(rows, cols)
        src = np.concatenate([ids[:, :-1].ravel(), ids[:-1, :].ravel()])
        dst = np.concatenate([ids[:, 1:].ravel(), ids[1:, :].ravel()])
        w = 1 + (src * 7 + dst * 3) % 4
        return cls(rows * cols, src, dst, w, np.ones(rows * cols, np.int64),
                   recorder)

    @property
    def n(self):
        return self._n

    @property
    def params(self):
        return types.SimpleNamespace(
            initial_tries=3, vcycles=1, contraction_stop_factor=4,
            cluster_weight_factor=3.0, stop_n_floor=12, stall_factor=0.95,
            recorder=self.recorder)

    def total_vwgt(self):
        return int(self.vwgt.sum())

    def cluster(self, max_cluster_weight, seed, protect=None):
        rng = np.random.default_rng(seed)
        cl = np.arange(self.n)
        used = np.zeros(self.n, bool)
        for e in rng.permutation(len(self.src)):
            u, v = self.src[e], self.dst[e]
            if used[u] or used[v] or any(p[u] != p[v] for p in protect or ()):
                continue
            if self.vwgt[u] + self.vwgt[v] <= max_cluster_weight:
                used[u] = used[v] = True
                cl[v] = u
        return cl

    def contract(self, clusters):
        _, cl = np.unique(clusters, return_inverse=True)
        nc = int(cl.max()) + 1
        cu, cv = cl[self.src], cl[self.dst]
        keep = cu != cv
        lo, hi = np.minimum(cu, cv)[keep], np.maximum(cu, cv)[keep]
        pairs, inv = np.unique(lo * nc + hi, return_inverse=True)
        w = np.bincount(inv, weights=self.w[keep]).astype(np.int64)
        vw = np.bincount(cl, weights=self.vwgt, minlength=nc)
        return StubMedium(nc, pairs // nc, pairs % nc, w, vw.astype(np.int64),
                          self.recorder), cl

    def _cap(self, k, eps):
        return (1.0 + eps) * np.ceil(self.total_vwgt() / k)

    def refine(self, part, k, eps, seed, force_balance=None):
        rng = np.random.default_rng(seed)
        part = np.asarray(part, np.int64).copy()
        bw = np.bincount(part, weights=self.vwgt, minlength=k)
        cap = self._cap(k, eps)
        for v in rng.permutation(self.n):
            nb = np.concatenate([self.dst[self.src == v],
                                 self.src[self.dst == v]])
            ws = np.concatenate([self.w[self.src == v], self.w[self.dst == v]])
            aff = np.bincount(part[nb], weights=ws, minlength=k)
            gain = aff - aff[part[v]]
            gain[bw + self.vwgt[v] > cap] = -np.inf
            gain[part[v]] = -np.inf
            b = int(np.argmax(gain + rng.random(k) * 1e-3))
            over = bw[part[v]] > cap
            if gain[b] > 0 or (over and np.isfinite(gain[b])):
                bw[part[v]] -= self.vwgt[v]
                bw[b] += self.vwgt[v]
                part[v] = b
        return part

    def refine_batch(self, parts, k, eps, seed, seeds=None, keys=None):
        if seeds is not None:
            rows = [int(s) for s in seeds]
        elif keys is not None:
            rows = [int(kk[1]) for kk in keys]   # PRNGKey(s) == [0, s]
        else:
            rows = [seed + i for i in range(len(parts))]
        return [self.refine(p, k, eps, s) for p, s in zip(parts, rows)]

    def polish(self, part, k, eps, seed):
        return part

    def initial_candidates(self, k, eps, seed):
        return [np.random.default_rng(seed + 101 * t).integers(0, k, self.n)
                for t in range(self.params.initial_tries)]

    def objective(self, part):
        part = np.asarray(part)
        return float(self.w[part[self.src] != part[self.dst]].sum())

    def imbalance(self, part, k):
        bw = np.bincount(np.asarray(part), weights=self.vwgt, minlength=k)
        return float(bw.max()) / np.ceil(self.total_vwgt() / k)

    def is_feasible(self, part, k, eps):
        return self.imbalance(part, k) <= 1.0 + eps + 1e-9


def _polish(part, seed):
    """A deterministic variant hook: move vertex seed mod n to the next
    block."""
    part = np.asarray(part, np.int64).copy()
    part[seed % len(part)] = (part[seed % len(part)] + 1) % 4
    return part


DRIVER_CASES = {
    "default": {},
    "no_migration": dict(migrate=False),
    "quickstart": dict(quickstart=True, population=3),
    "balanced": dict(replacement="balanced"),
    "combine_0": dict(combine_prob=0.0),
    "combine_1": dict(combine_prob=1.0),
    "sequential": dict(batched_generations=False),
    "interval_2_polish": dict(migration_interval=2, n_islands=3,
                              polish=True, generations=4),
}


def _evolve(pkg_mem, pkg_obs, case, seed=5):
    kw = dict(n_islands=2, population=2, generations=3, time_limit=0.0)
    kw.update(case)
    polish = kw.pop("polish", False)
    rec = pkg_obs.Recorder("memetic")
    medium = StubMedium.grid(8, 9, recorder=rec)
    state = pkg_mem.evolve_islands(medium, 4, 0.05,
                                   pkg_mem.MemeticConfig(**kw), seed,
                                   polish_fn=_polish if polish else None)
    counters = {k: v for k, v in rec.counters().items()
                if k.startswith(("memetic/", "engine/"))}
    return state, counters, rec.trajectory("memetic", "fitness")


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_driver_identical_to_reference_on_stub_medium(case):
    """The island loop, bit for bit: every island's members (partition,
    fitness, balance, stamp, feasibility), the generation count, the
    ``memetic/*`` and ``engine/*`` counters and the best-fitness
    trajectory."""
    rs, rc, rt = _evolve(rMEM, robs, DRIVER_CASES[case])
    ts, tc, tt = _evolve(tMEM, tobs, DRIVER_CASES[case])
    assert ts.generations == rs.generations
    assert tc == rc and tc.get("memetic/combines", 0) + tc.get(
        "memetic/mutations", 0) > 0
    assert tt == rt
    assert len(ts.islands) == len(rs.islands)
    for tp, rp in zip(ts.islands, rs.islands):
        assert len(tp) == len(rp)
        for a, b in zip(tp, rp):
            assert np.array_equal(a.part, b.part)
            assert a.key() == b.key() and a.feasible == b.feasible
    assert np.array_equal(ts.best_part(), rs.best_part())


def test_sweep_seeds_are_the_reference_key_words():
    """Row i of generation gen draws from island_seed(seed, i) +
    STRIDE_SWEEP·gen: the second word of the reference's key."""
    for seed, gen in ((0, 1), (7, 3), (123456, 9)):
        keys = rD._sweep_keys(seed, [0, 1, 2], gen)
        assert tD._sweep_seeds(seed, [0, 1, 2], gen) == [
            int(k[1]) for k in keys]
        assert all(int(k[0]) == 0 for k in keys)
    assert (tD.STRIDE_ISLAND, tD.STRIDE_MEMBER, tD.STRIDE_COMBINE,
            tD.STRIDE_MUTATE, tD.STRIDE_SWEEP) == (
        rD.STRIDE_ISLAND, rD.STRIDE_MEMBER, rD.STRIDE_COMBINE,
        rD.STRIDE_MUTATE, rD.STRIDE_SWEEP)


# -- validation: the reference's errors ---------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_islands=0), dict(n_islands=-2), dict(n_islands=1.5),
    dict(population=0), dict(time_limit=-1.0),
    dict(time_limit=float("nan")), dict(generations=-1),
    dict(generations=1.0),
])
def test_validate_memetic_params_same_errors(kw):
    base = dict(n_islands=2, population=2, time_limit=1.0, generations=None)
    base.update(kw)
    with pytest.raises(ValueError) as want:
        rMEM.validate_memetic_params(**base)
    with pytest.raises(ValueError) as got:
        tMEM.validate_memetic_params(**base)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(migration_interval=0),
                                dict(combine_prob=1.5),
                                dict(replacement="nope")])
def test_config_errors_same_as_reference(kw):
    cfg = dict(n_islands=1, population=1, generations=1)
    cfg.update(kw)
    with pytest.raises(ValueError) as want:
        rMEM.evolve_islands(StubMedium.grid(4, 4), 2, 0.05,
                            rMEM.MemeticConfig(**cfg), 1)
    with pytest.raises(ValueError) as got:
        tMEM.evolve_islands(StubMedium.grid(4, 4), 2, 0.05,
                            tMEM.MemeticConfig(**cfg), 1)
    assert str(got.value) == str(want.value)


def test_entry_points_validate_before_work():
    hg = tgen.planted_hypergraph(60, 90, blocks=2, seed=1)
    with pytest.raises(ValueError):
        tE.kaffpaE(GRID, 4, 0.03, "fast", n_islands=0, device="cpu")
    with pytest.raises(ValueError):
        tif.kaffpaE(GRID.n, None, GRID.xadj, None, GRID.adjncy, 4, 0.03,
                    time_limit=-1.0, device="cpu")
    with pytest.raises(ValueError):
        tif.kahyparE(hg.n, hg.m, None, None, hg.eptr, hg.eind, 4, 0.03,
                     n_islands=0, device="cpu")
    with pytest.raises(ValueError):
        tNS.memetic_node_separator(GRID, 0.2, "fast", population=-1,
                                   device="cpu")
    with pytest.raises(ValueError):
        tif.node_separator(GRID.n, None, GRID.xadj, None, GRID.adjncy, 2,
                           0.2, memetic=True, time_limit=-1.0, device="cpu")


# -- migration ---------------------------------------------------------------

def test_ring_roll_semantics_and_host_parity():
    parts = np.arange(4, dtype=np.int32)[:, None] * np.ones((1, 3), np.int32)
    assert [int(r[0]) for r in tMEM.ring_roll(parts, 1)] == [3, 0, 1, 2]
    rng = np.random.default_rng(0)
    parts = rng.integers(0, 7, size=(5, 37)).astype(np.int32)
    for shift in range(-2, 7):
        got = tMEM.ring_roll(parts, shift)
        assert got.dtype == np.int32
        assert np.array_equal(got, rMEM.ring_roll(parts, shift))
        assert np.array_equal(tMEM.ring_roll_host(parts, shift),
                              rMEM.ring_roll_host(parts, shift))


def test_a_mesh_is_refused_never_ignored():
    """A mesh that is not a ``repro_torch.core.mesh.Mesh`` (a stand-in
    object, a jax ``Mesh``) raises TypeError at every entry that takes
    one; nothing falls back to running without it."""
    mesh = types.SimpleNamespace(devices=np.array(["a", "b"]))
    one = types.SimpleNamespace(devices=np.array(["a"]))
    jmesh = JMesh(np.array(jax.devices()[:1]), ("islands",))
    hg = tgen.planted_hypergraph(60, 90, blocks=2, seed=1)
    with pytest.raises(TypeError, match="core.mesh.Mesh"):
        tMEM.ring_roll(np.zeros((2, 3), np.int32), 1, mesh=one)
    with pytest.raises(TypeError, match="core.mesh.Mesh"):
        tMEM.evolve_islands(StubMedium.grid(4, 4), 2, 0.05,
                            tMEM.MemeticConfig(n_islands=1, population=1,
                                               generations=0), 1, mesh=one)
    with pytest.raises(TypeError, match="core.mesh.Mesh"):
        tE.kaffpaE(GRID, 2, 0.03, "fast", generations=0, mesh=one,
                   device="cpu")
    for m in (one, mesh, jmesh):
        with pytest.raises(TypeError, match="core.mesh.Mesh"):
            tH.kahyparE(hg, 2, 0.03, "fast", generations=0, mesh=m,
                        device="cpu")
        with pytest.raises(TypeError, match="core.mesh.Mesh"):
            tNS.memetic_node_separator(GRID, 0.2, "fast", generations=0,
                                       mesh=m, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tE.kaffpaE(GRID, 2, 0.03, "fast", generations=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tNS.memetic_node_separator(GRID, 0.2, "fast", generations=0)


# -- port contracts on the real media ----------------------------------------

def _graph_medium(g, preset="fast"):
    return tK.GraphMedium(g, tK.PRESETS[preset], device="cpu")


def test_no_migration_islands_evolve_independently():
    """With migration off, island i's trajectory is bit-identical to a solo
    run at island_seed(seed, i): the sweep row seeds depend on the island
    alone, not on its row in the batch."""
    seed = 11
    multi = tMEM.evolve_islands(
        _graph_medium(GRID), 4, 0.03,
        tMEM.MemeticConfig(n_islands=3, population=2, generations=2,
                           migrate=False), seed)
    for i in range(3):
        solo = tMEM.evolve_islands(
            _graph_medium(GRID), 4, 0.03,
            tMEM.MemeticConfig(n_islands=1, population=2, generations=2,
                               migrate=False), tMEM.island_seed(seed, i))
        for x, y in zip(multi.islands[i], solo.islands[0]):
            assert np.array_equal(x.part, y.part)
            assert x.key() == y.key()


@pytest.mark.parametrize("medium", ["graph", "hypergraph", "separator"])
def test_batched_generations_equal_sequential(medium):
    """The generation sweep in one batched call equals one call per island
    (row independence) on every medium."""
    def make():
        if medium == "graph":
            return _graph_medium(tgen.grid2d(12, 12)), 2, 0.05
        if medium == "hypergraph":
            hg = tgen.planted_hypergraph(80, 120, blocks=2, seed=3)
            return tHD.HypergraphMedium(hg, tHD.PRESETS["fast"],
                                        device="cpu"), 2, 0.05
        return tNS.SeparatorMedium(tgen.grid2d(12, 12), tNS.PRESETS["fast"],
                                   device="cpu"), 2, 0.2

    base = dict(n_islands=2, population=2, time_limit=0.0, generations=2)
    runs = []
    for batched in (True, False):
        m, k, eps = make()
        runs.append(tMEM.evolve_islands(
            m, k, eps, tMEM.MemeticConfig(**base,
                                          batched_generations=batched), 7))
    for pa, pb in zip(runs[0].islands, runs[1].islands):
        for a, b in zip(pa, pb):
            assert np.array_equal(a.part, b.part)
            assert a.fitness == b.fitness


@pytest.mark.parametrize("medium", ["graph", "hypergraph", "separator"])
def test_refine_batch_seeds_set_each_row(medium):
    """``seeds=`` gives each row its own generator: a row refined in a
    batch equals the same row refined alone at its seed."""
    g = tgen.grid2d(12, 12)
    if medium == "graph":
        m, k, eps = _graph_medium(g), 2, 0.05
        parts = [np.random.default_rng(s).integers(0, 2, g.n) for s in (1, 2)]
    elif medium == "hypergraph":
        hg = tgen.planted_hypergraph(80, 120, blocks=2, seed=3)
        m, k, eps = tHD.HypergraphMedium(hg, tHD.PRESETS["fast"],
                                         device="cpu"), 2, 0.05
        parts = [np.random.default_rng(s).integers(0, 2, hg.n)
                 for s in (1, 2)]
    else:
        m, k, eps = tNS.SeparatorMedium(g, tNS.PRESETS["fast"],
                                        device="cpu"), 2, 0.2
        parts = m.initial_candidates(2, 0.2, 3)[:2]
    both = m.refine_batch(parts, k, eps, 0, seeds=[101, 202])
    assert np.array_equal(both[0], m.refine_batch(parts[:1], k, eps, 0,
                                                  seeds=[101])[0])
    assert np.array_equal(both[1], m.refine_batch(parts[1:], k, eps, 0,
                                                  seeds=[202])[0])


def test_population_member_j_is_one_run():
    """Member j is ``run(medium, k, eps, seed + stride·j)`` bit for bit,
    V-cycles included (strong preset: vcycles=2)."""
    g = tgen.grid2d(12, 12)
    pop = tML.population(_graph_medium(g, "strong"), 4, 0.03, 5, 2,
                         stride=31)
    for j, part in enumerate(pop):
        assert np.array_equal(part, tML.run(_graph_medium(g, "strong"), 4,
                                            0.03, 5 + 31 * j))


def test_strong_member0_matches_single_run():
    """At generations=0 with one member the memetic result is one single
    run, on graphs and hypergraphs alike."""
    g = tgen.grid2d(12, 12)
    pe = tE.kaffpaE(g, 4, 0.03, "strong", n_islands=1, population=1,
                    generations=0, seed=4, device="cpu")
    assert np.array_equal(pe, tK.kaffpa(g, 4, 0.03, "strong", seed=4,
                                        device="cpu"))
    hg = tgen.planted_hypergraph(100, 150, blocks=2, seed=9)
    pe = tH.kahyparE(hg, 2, 0.03, "strong", seed=4, n_islands=1,
                     population=1, generations=0, device="cpu")
    assert np.array_equal(pe, tH.kahypar(hg, 2, 0.03, "strong", seed=4,
                                         device="cpu"))


def test_combine_child_no_worse_than_seeding_parent():
    g = tgen.grid2d(12, 12)
    m = _graph_medium(g)
    pa = tML.run(m, 4, 0.03, 1)
    pb = tML.run(m, 4, 0.03, 2)
    child = tML.combine(m, pa, pb, 4, 0.03, 3)
    assert edge_cut(g, child) <= min(edge_cut(g, pa), edge_cut(g, pb))


def test_evolve_combine_and_mutate_are_the_engine_operators():
    """``evolve.combine`` / ``mutate`` (the reference's graph-level
    operators, for a call outside an evolution) are ``ML.combine`` /
    ``ML.vcycle`` on a medium of their own, and the child is never worse
    than the better parent (tests/test_distributed.py's contract)."""
    g = tgen.grid2d(12, 12)
    cfg = tK.PRESETS["fast"]
    pa = tK.kaffpa(g, 4, 0.03, "fast", seed=1, device="cpu")
    pb = tK.kaffpa(g, 4, 0.03, "fast", seed=2, device="cpu")
    child = tE.combine(g, pa, pb, 4, 0.03, cfg, seed=3, device="cpu")
    assert np.array_equal(child, tML.combine(_graph_medium(g), pa, pb, 4,
                                             0.03, 3))
    assert edge_cut(g, child) <= min(edge_cut(g, pa), edge_cut(g, pb))
    assert is_feasible(g, child, 4, 0.03)
    mutant = tE.mutate(g, pa, 4, 0.03, cfg, seed=3, device="cpu")
    assert np.array_equal(mutant, tML.vcycle(_graph_medium(g), pa, 4, 0.03,
                                             3))
    assert edge_cut(g, mutant) <= edge_cut(g, pa)
    assert is_feasible(g, mutant, 4, 0.03)


def test_infeasible_child_never_evicts_feasible_member():
    feas = tMEM.Individual(np.zeros(4, np.int64), 100.0, 1.0, 1,
                           feasible=True)
    bad = tMEM.Individual(np.ones(4, np.int64), 50.0, 1.5, 2, feasible=False)
    for rule in ("worst", "balanced"):
        rkey = _replace_key(tMEM.MemeticConfig(replacement=rule))
        assert not rkey(bad) <= rkey(feas), rule
        assert rkey(feas) <= rkey(bad), rule


def test_time_limit_zero_builds_only_the_initial_population():
    rec = tobs.Recorder("memetic")
    m = tK.GraphMedium(GRID, tK.PRESETS["fast"], recorder=rec, device="cpu")
    state = tMEM.evolve_islands(m, 4, 0.03,
                                tMEM.MemeticConfig(n_islands=2, population=2,
                                                   time_limit=0), 5)
    assert state.generations == 0
    assert [len(p) for p in state.islands] == [2, 2]
    assert not any(k.startswith("memetic/") for k in rec.counters())
    part = tE.kaffpaE(GRID, 4, 0.03, "fast", n_islands=1, population=2,
                      time_limit=0, seed=5, device="cpu")
    assert is_feasible(GRID, part, 4, 0.03)


def test_trajectory_reproducible():
    kw = dict(n_islands=2, population=2, generations=2, seed=13,
              device="cpu")
    assert np.array_equal(tE.kaffpaE(GRID, 4, 0.03, "fast", **kw),
                          tE.kaffpaE(GRID, 4, 0.03, "fast", **kw))


# -- quality: the reference's band --------------------------------------------

HG_ARGS = (200, 300)
HG_KW = dict(blocks=4, seed=11)


def _graph_run(pkg, program, seed):
    g = tgen.grid2d(20, 20)
    if pkg == "ref":
        single, memetic, kw = rK.kaffpa, rE.kaffpaE, {}
    else:
        single, memetic, kw = tK.kaffpa, tE.kaffpaE, dict(device="cpu")
    if program == "single":
        part = single(g, 4, 0.03, "fast", seed=seed, **kw)
    else:
        part = memetic(g, 4, 0.03, "fast", n_islands=2, population=2,
                       generations=2, seed=seed, **kw)
    assert is_feasible(g, part, 4, 0.03)
    return edge_cut(g, part)


def _hyper_run(pkg, objective, program, seed):
    H = rH if pkg == "ref" else tH
    gen = rgen if pkg == "ref" else tgen
    hg = gen.planted_hypergraph(*HG_ARGS, **HG_KW)
    kw = {} if pkg == "ref" else dict(device="cpu")
    if program == "single":
        part = H.kahypar(hg, 4, 0.03, "eco", seed=seed, objective=objective,
                         **kw)
    else:
        part = H.kahyparE(hg, 4, 0.03, "eco", seed=seed, objective=objective,
                          n_islands=2, population=2, generations=2, **kw)
    assert H.is_feasible(hg, part, 4, 0.03)
    score = H.connectivity if objective == "km1" else H.cut_net
    return score(hg, part)


def _sep_run(pkg, program, seed):
    NS = rNS if pkg == "ref" else tNS
    g = (rgen if pkg == "ref" else tgen).grid2d(32, 32)
    kw = {} if pkg == "ref" else dict(device="cpu")
    if program == "single":
        sep, part2 = NS.multilevel_node_separator(g, 0.2, "eco", seed=seed,
                                                  **kw)
    else:
        sep, part2 = NS.memetic_node_separator(g, 0.2, "eco", seed=seed,
                                               n_islands=2, population=2,
                                               generations=2, **kw)
    labels = part2.copy()
    labels[sep] = tNS.SEP
    assert tNS.separator_is_feasible(tgen.grid2d(32, 32), labels, 0.2)
    assert tNS.separator_invariant_ok(tgen.grid2d(32, 32), labels)
    return int(g.vwgt[sep].sum())


CELLS = {
    "kaffpaE_grid20_k4": _graph_run,
    "kahyparE_km1_planted200_k4":
        lambda pkg, prog, s: _hyper_run(pkg, "km1", prog, s),
    "kahyparE_cut_planted200_k4":
        lambda pkg, prog, s: _hyper_run(pkg, "cut", prog, s),
    "memetic_sep_grid32": lambda pkg, prog, s: _sep_run(pkg, prog, s),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_memetic_quality_band(cell):
    """The port's memetic result, summed over 3 seeds, within 1.15× of the
    reference's at generations=2; at every seed no worse than the port's
    own single run (member 0 of island 0 is that run)."""
    run = CELLS[cell]
    ref = sum(run("ref", "memetic", s) for s in SEEDS)
    port = []
    for s in SEEDS:
        port.append(run("port", "memetic", s))
        assert port[-1] <= run("port", "single", s), (cell, s)
    assert sum(port) <= BAND * ref, (cell, port, ref)
