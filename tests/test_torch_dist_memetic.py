"""The memetic programs over a mesh of 4 gloo ranks (CPU processes,
``file://`` store, no network).

Every rank runs the island loop with the same seeds; only the migration
exchanges blocks (`Mesh.ppermute`).  So ``ring_roll`` over the ranks must
equal ``np.roll`` at every shift, take the host roll when the rank count
does not divide the island count, and kaffpaE over an ``islands`` mesh
must give exactly the partition of ``mesh=None`` (under a wall-clock
budget, the same partition on every rank).  kahyparE on 4 ranks
adds the distributed parhyp polish of every child (the nets re-view of
the same ranks): feasible, the same on every rank, and never above its
member-0 run (``kahypar`` at the seed).
"""
import numpy as np
import pytest

import torch_ranks as TR
from repro_torch.core import memetic as MEM
from repro_torch.core.mesh import Mesh


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return TR.run_ranks("rank_memetic", 4, tmp_path_factory.mktemp("mem4"))


@pytest.mark.parametrize("n_isl", [4, 8])
def test_ring_roll_over_ranks_is_np_roll(four_ranks, n_isl):
    for out in four_ranks:
        assert out[f"roll{n_isl}"].all(), out[f"roll{n_isl}"]
        # shifts -1..I+1: the two multiples of I move nothing, the rest
        # exchange one block (I = 4) or two (I = 8, shifts off the grid)
        assert int(out[f"ppermutes{n_isl}"]) > 0


def test_ring_roll_takes_the_host_path_when_ranks_do_not_divide(four_ranks):
    for out in four_ranks:
        assert out["roll6"].all()
        assert int(out["ppermutes6"]) == 0


def test_kaffpaE_over_an_islands_mesh_equals_no_mesh(four_ranks):
    for out in four_ranks:
        np.testing.assert_array_equal(out["kaffpaE_mesh"],
                                      out["kaffpaE_none"])
        np.testing.assert_array_equal(out["kaffpaE_mesh"],
                                      four_ranks[0]["kaffpaE_mesh"])


def test_a_time_budget_stops_every_rank_at_one_generation(four_ranks):
    """Under ``time_limit`` the ranks agree each generation whether to go
    on: none hangs in a migration the others skip, and all end alike."""
    for out in four_ranks:
        np.testing.assert_array_equal(out["kaffpaE_timed"],
                                      four_ranks[0]["kaffpaE_timed"])


def test_kahyparE_on_four_ranks_feasible_and_never_above_member0(
        four_ranks):
    for out in four_ranks:
        np.testing.assert_array_equal(out["kahyparE"],
                                      four_ranks[0]["kahyparE"])
        assert bool(out["kahyparE_feasible"])
        assert int(out["kahyparE_km1"]) <= int(out["kahypar_km1"])


def test_one_rank_ring_roll_is_the_host_roll():
    mesh = Mesh.local(("islands",), device="cpu")
    parts = np.random.default_rng(2).integers(0, 5, (3, 11)).astype(np.int32)
    for shift in range(-1, 5):
        np.testing.assert_array_equal(MEM.ring_roll(parts, shift, mesh),
                                      MEM.ring_roll_host(parts, shift))
    assert MEM.islands_mesh(mesh).axis_names == ("islands",)
