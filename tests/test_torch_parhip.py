"""Port parity: parhip, the distributed edge partition and the mesh.

At one rank the parhip round gets the JAX package's own per-shard draws
(``uniform(fold_in(key_r, shard), (rows, k))``) and must agree bit for bit
with ``repro.core.parhip._parhip_refine_jit`` on a 1-device mesh.  On 4
gloo ranks (CPU processes, ``file://`` store, no network) each rank gets
its shard's draws and the gathered labels must equal the reference's on 4
fake host devices.  End to end the two packages draw from different
generators, so parhip's cut and the distributed edge partition's
replication are held, summed over seeds 1–3, within 1.15× of the
reference's on grid2d(32, 32) at k = 4.
"""
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from repro.core import edgepart as rEP
from repro.core import parhip as rP
from repro.io import generators as rgen

import torch_ranks as TR
from repro_torch.core import edgepart as tEP
from repro_torch.core import parhip as tP
from repro_torch.core.mesh import Mesh, check_mesh, device_of
from repro_torch.core.partition import (edge_cut, edge_partition_metrics,
                                        is_feasible)
from repro_torch.io import generators as tgen

BAND = 1.15
SEEDS = (1, 2, 3)
GRID = tgen.grid2d(*TR.GRID)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the mesh -------------------------------------------------------------------

def test_local_mesh_collectives_are_the_identity():
    mesh = Mesh.local(("nets", "verts"), device="cpu")
    x = torch.arange(6.0)
    assert mesh.size == 1 and mesh.rank == 0 and mesh.group is None
    assert mesh.psum(x, "nets") is x and mesh.pmax(x, "verts") is x
    assert mesh.pmin(x, None) is x and mesh.all_gather(x) is x
    assert mesh.axis_index("verts") == 0 and mesh.extent("nets") == 1
    assert torch.equal(Mesh.local(("islands",), "cpu").ppermute(x, [(0, 0)]),
                       x)
    with pytest.raises(ValueError, match="1-D"):
        mesh.ppermute(x, [(0, 0)])
    assert mesh.agree(True) and not mesh.agree(False)
    with pytest.raises(ValueError, match="no 'islands'"):
        mesh.psum(x, "islands")


def test_mesh_shapes_and_devices_are_checked():
    with pytest.raises(ValueError, match="needs a process group"):
        Mesh((2,), ("nodes",), device="cpu")
    with pytest.raises(ValueError, match="bad mesh shape"):
        Mesh((1, 1), ("nodes",), device="cpu")
    with pytest.raises(ValueError, match="bad mesh shape"):
        Mesh((1, 1), ("a", "a"), device="cpu")
    mesh = Mesh.local(device="cpu")
    assert device_of(mesh) == torch.device("cpu")
    assert device_of(None, "cpu") == torch.device("cpu")
    with pytest.raises(TypeError, match="core.mesh.Mesh"):
        check_mesh(types.SimpleNamespace(devices=np.array(["a"])))
    with pytest.raises(TypeError, match="core.mesh.Mesh"):
        check_mesh(JMesh(np.array(jax.devices()[:1]), ("nodes",)))
    view = mesh.view((1,), ("islands",))
    assert view.axis_names == ("islands",) and view.device == mesh.device


# -- sharding and the round ------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 4, 8])
def test_shard_graph_equals_reference(shards):
    want = rP.shard_graph(rgen.grid2d(*TR.GRID), shards)
    got = tP.shard_graph(GRID, shards)
    for f in ("src", "dst", "w", "vwgt"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.n, got.rows, got.n_pad) == (want.n, want.rows, want.n_pad)


@pytest.mark.parametrize("k", [2, 4])
def test_one_rank_round_bit_identical(k):
    """Given the reference's draws, the port's scan at one rank equals
    ``_parhip_refine_jit`` on a 1-device mesh."""
    g = rgen.grid2d(*TR.GRID)
    sg = rP.shard_graph(g, 1)
    labels0 = np.zeros(sg.n_pad, np.int32)
    labels0[:g.n] = np.random.default_rng(k).integers(0, k, g.n)
    cap = 1.03 * np.ceil(g.total_vwgt() / k)
    rounds, seed = 8, 5
    want = rP._parhip_refine_jit(
        JMesh(np.array(jax.devices()[:1]), ("nodes",)),
        *(jnp.asarray(a) for a in (sg.src, sg.dst, sg.w, sg.vwgt)),
        jnp.asarray(labels0), jnp.full((k,), cap, jnp.float32),
        jax.random.PRNGKey(seed), sg.rows, k, rounds, 1, "nodes")
    keys = jax.random.split(jax.random.PRNGKey(seed), rounds)
    noise = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(kr, 0), (sg.rows, k), jnp.float32, 0.0, 1e-4))
        for kr in keys])
    got = tP._parhip_refine(
        Mesh.local(device="cpu"), _t(sg.src[0]), _t(sg.dst[0]), _t(sg.w[0]),
        _t(sg.vwgt.reshape(-1)), _t(labels0),
        torch.full((k,), cap, dtype=torch.float32), _t(noise), sg.rows, k,
        rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[:g.n] != labels0[:g.n]).any()


def test_refine_never_worse_and_counts_its_rounds():
    from repro_torch import obs
    part0 = np.random.default_rng(3).integers(0, 4, GRID.n)
    rec = obs.Recorder()
    with obs.use(rec):
        out = tP.parhip_refine(GRID, part0, 4, 0.03, rounds=8, seed=1,
                               device="cpu")
    assert edge_cut(GRID, out) < edge_cut(GRID, part0)
    assert rec.counters()["parhip/dist_rounds"] == 8
    # an infeasible result is rejected: the input comes back unchanged
    lopsided = np.zeros(GRID.n, np.int64)
    with obs.use(rec):
        back = tP.parhip_refine(GRID, lopsided, 4, 0.03, rounds=2, seed=1,
                                device="cpu")
    assert back is lopsided
    assert rec.counters()["parhip/rounds_rejected"] == 1


def test_single_level_refines(monkeypatch):
    """Port of test_distributed.py::test_parhip_single_level_refines:
    a single-level hierarchy still runs the distributed refiner and the
    repair at level 0."""
    calls = []
    orig = tP.parhip_refine
    monkeypatch.setattr(tP, "parhip_refine",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    small = tgen.grid2d(6, 6)
    part = tP.parhip(small, 4, 0.03, "ultrafastmesh", seed=3, device="cpu")
    assert calls, "level-0 refinement must run on single-level hierarchies"
    assert is_feasible(small, part, 4, 0.03)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tP.parhip(GRID, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tEP.distributed_edge_partition(GRID, 4)
    with pytest.raises(ValueError, match="1-D"):
        tP.parhip(GRID, 4, mesh=Mesh.local(("nets", "verts"), "cpu"))


# -- end to end ------------------------------------------------------------------

def _parhip_cut(pkg, seed):
    if pkg == "ref":
        g = rgen.grid2d(*TR.GRID)
        part = rP.parhip(g, 4, 0.03, "fastmesh", seed=seed)
    else:
        g = GRID
        part = tP.parhip(g, 4, 0.03, "fastmesh", seed=seed, device="cpu")
    assert is_feasible(GRID, part, 4, 0.03)
    return edge_cut(GRID, part)


def _edgepart_replication(pkg, seed):
    if pkg == "ref":
        ep = rEP.distributed_edge_partition(rgen.grid2d(*TR.GRID), 4,
                                            seed=seed)
    else:
        ep = tEP.distributed_edge_partition(GRID, 4, seed=seed,
                                            device="cpu")
    assert ep.shape == (GRID.m,) and ep.min() >= 0 and ep.max() < 4
    return edge_partition_metrics(GRID, ep, 4)["replication"]


@pytest.mark.parametrize("run", [_parhip_cut, _edgepart_replication],
                         ids=["parhip_cut", "edgepart_replication"])
def test_quality_band(run):
    ref = sum(run("ref", s) for s in SEEDS)
    port = [run("port", s) for s in SEEDS]
    assert sum(port) <= BAND * ref, (port, ref)


# -- four gloo ranks --------------------------------------------------------------

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parhip4")
    ref = TR.run_reference("ref_parhip", 4, tmp)
    rows = tP.shard_graph(GRID, 4).rows
    ranks = TR.run_ranks("rank_parhip", 4, tmp,
                         noise=TR.parhip_noise(rows, 4))
    return ref, ranks


def test_four_rank_round_equals_the_reference(four_ranks):
    """Each rank refines its shard with the reference's draws for it; the
    gathered labels equal ``_parhip_refine_jit`` on 4 fake devices."""
    ref, ranks = four_ranks
    for out in ranks:
        np.testing.assert_array_equal(out["labels"], ref["labels"])


def test_four_rank_parhip_is_replicated_and_feasible(four_ranks):
    _, ranks = four_ranks
    for out in ranks:
        np.testing.assert_array_equal(out["part"], ranks[0]["part"])
        assert bool(out["feasible"])
        assert int(out["cut"]) == edge_cut(GRID, out["part"])
