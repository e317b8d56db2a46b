"""Port parity: the dry run (`repro_torch.launch.dryrun`) against the
JAX package's (`repro.launch.dryrun`) where both have the number.

The reference compiles each cell on 512 fake devices; the port runs the
cell's step on fake tensors (``FakeTensorMode``) with a stand-in rank that
counts its collectives.  Held here, at ``reduced()`` configs unless said:

  * the per-rank parameter and cache bytes under the reference's specs
    equal the reference's ``build_cell`` argument tree under its
    ``in_specs``, each dim split over the product of its axes' extents
    and rounded up (as ``chip_smoke.py`` phase 51 counts them);
  * ``model_flops`` and the configs' parameter counts equal the
    reference's;
  * the stand-in's collective counts equal what 4 gloo ranks count
    (`tests/torch_ranks.py::rank_counts`) for a tensor-parallel forward
    or a train step, and the extrapolation from 1 and 2 layers equals a
    4-layer count;
  * at full width, gemma2-9B's ``train_4k`` step on (data 2, model 2)
    and zamba2-2.7B's ``long_500k`` decode step make the collectives the
    4-card tool counted on four H100s (``PERF.md`` §6).
"""
import dataclasses
import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.core.mesh import (ALL_GATHER, ALL_REDUCE, ALL_TO_ALL,
                                   PPERMUTE, REDUCE_SCATTER)
from repro_torch.launch import dryrun as D
from repro_torch.models import shardings as SH
from repro_torch.models import transformer as T

sys.path.insert(0, str(Path(__file__).parent))
import torch_ranks  # noqa: E402

KINDS = (ALL_REDUCE, ALL_GATHER, REDUCE_SCATTER, ALL_TO_ALL)
AXES = ("data", "model")

_COUNTS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _count_ranks(tmp_path_factory):
    """4 gloo ranks counting their collectives, beside the other tests."""
    tmp = tmp_path_factory.mktemp("counts")

    def run():
        try:
            _COUNTS["out"] = torch_ranks.run_ranks("rank_counts", 4, tmp)
        except Exception as exc:  # noqa: BLE001 — re-raised by the test
            _COUNTS["error"] = exc

    th = threading.Thread(target=run)
    th.start()
    _COUNTS["thread"] = th
    yield
    th.join()


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, imported with the environment it sets
    (512 fake host devices) put back: only its pure functions are used."""
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as RD
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return RD


class _RefMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, axes, sizes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, sizes))


def _spec_bytes(tree, specs, ext) -> int:
    import jax
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree_util.tree_leaves(tree)
    sps = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P) or x is None)
    assert len(leaves) == len(sps)
    total = 0
    for leaf, sp in zip(leaves, sps):
        sp = tuple(sp) + (None,) * (len(leaf.shape) - len(tuple(sp)))
        n = 1
        for dim, e in zip(leaf.shape, sp):
            axes = e if isinstance(e, tuple) else (e,)
            k = int(np.prod([ext[a] for a in axes if a is not None]))
            n *= -(-dim // k)
        total += n
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_bytes_equal_reference_in_specs(arch, ref_dryrun):
    from repro.configs.base import get_config as rget
    rcfg = rget(arch).reduced()
    cfg = get_config(arch).reduced()
    for sizes in ((1, 4), (2, 2)):
        ext = dict(zip(AXES, sizes))
        for shape in ("train_4k", "decode_32k"):
            _, _, args, in_specs, _ = ref_dryrun.build_cell(arch, shape,
                                                            cfg=rcfg)
            sp = in_specs(_RefMesh(AXES, sizes))
            want_p = _spec_bytes(args[0], sp[0], ext)
            want_c = (_spec_bytes(args[2], sp[2], ext)
                      if shape != "train_4k" else 0)
            got_p = D.spec_param_bytes(cfg, AXES, sizes)
            shp = SHAPES[shape]
            got_c = (D.spec_cache_bytes(cfg, shp["global_batch"],
                                        shp["seq_len"], AXES, sizes)
                     if shape != "train_4k" else 0)
            # the reference's tree is bf16, the port's at f32: elements
            assert (got_p // 4, got_c // 4) == (want_p, want_c), \
                (arch, sizes, shape)


def test_held_bytes_equal_spec_bytes_where_the_port_follows_the_specs():
    """The port's own blocks (``init_params``/``init_caches`` with the
    stand-in as mesh) hold exactly the specs' bytes on the archs whose
    layout does not depart from them (`models/shardings.py`)."""
    for arch in ("minicpm_2b", "whisper_medium"):
        cfg = get_config(arch).reduced()
        for sizes in ((1, 4), (2, 2)):
            rank = D.RankStandIn(AXES, sizes)
            got = D.step_costs(cfg, "decode_32k", rank, params_only=True)
            shp = SHAPES["decode_32k"]
            assert (got["params"], got["caches"]) == (
                D.spec_param_bytes(cfg, AXES, sizes),
                D.spec_cache_bytes(cfg, shp["global_batch"], shp["seq_len"],
                                   AXES, sizes)), (arch, sizes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    from repro.configs.base import SHAPES as RSHAPES, get_config as rget
    rcfg, cfg = rget(arch), get_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    for shape, shp in RSHAPES.items():
        # the reference's run_cell, line for line
        n_active = rcfg.active_param_count()
        if shp["kind"] == "train":
            tokens = shp["global_batch"] * shp["seq_len"]
            want = 6.0 * n_active * tokens
        elif shp["kind"] == "prefill":
            tokens = shp["global_batch"] * shp["seq_len"]
            want = 2.0 * n_active * tokens
        else:
            tokens = shp["global_batch"]
            want = 2.0 * n_active * tokens
        assert D.model_flops(cfg, shape) == (want, tokens)
    assert SHAPES == RSHAPES


def _standin_counts(arch, sizes, what):
    cfg = get_config(arch).reduced()
    rank = D.RankStandIn(AXES, sizes)
    with FakeTensorMode():
        model = T.init_params(cfg, 0, mesh=rank)
        toks = torch.randint(0, cfg.vocab, (D.rank_rows(rank, 2),
                                            torch_ranks.COUNT_L + 1))
        rank.reset()
        with SH.use_mesh(rank):
            torch_ranks.count_run(torch, cfg, model, what, toks)
    return [rank.counts()["calls"][k] for k in KINDS]


def test_standin_counts_equal_gloo_ranks():
    _COUNTS["thread"].join()
    if "error" in _COUNTS:
        raise _COUNTS["error"]
    ranks = _COUNTS["out"]
    for arch, sizes, what in torch_ranks.COUNT_RUNS:
        got = _standin_counts(arch, sizes, what)
        want = ranks[0][f"calls/{arch}/{what}"].tolist()
        assert got == want, (arch, sizes, what, got, want)
        assert sum(want) > 0
        for r in ranks[1:]:
            assert r[f"calls/{arch}/{what}"].tolist() == want


@pytest.mark.parametrize("arch,shape,sizes", [
    ("minicpm_2b", "train_4k", (2, 2)),
    ("llama4_scout_17b_a16e", "decode_32k", (1, 4)),
    ("whisper_medium", "prefill_32k", (2, 2))])
def test_extrapolation_equals_a_direct_count(arch, shape, sizes):
    """F1 + (trips − 1)·(F2 − F1) from 1- and 2-layer variants equals the
    4-layer step's collectives and FLOPs (whisper: 4 decoder and 2
    encoder layers, its third variant)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=4)
    rank = D.RankStandIn(AXES, sizes)
    got = D.extrapolated(cfg, shape, rank, torch.float32, "full", 1)
    want = D.step_costs(cfg, shape, rank, torch.float32)
    assert got["collectives"] == want["collectives"]
    assert got["flops"] == want["flops"]
    assert want["flops"] > 0
    assert got["params"] == want["params"]


def test_full_width_collectives_equal_the_four_card_counts():
    """gemma2-9B ``train_4k`` on (2, 2), remat "full", 1 microbatch: 590
    all-gathers, 295 reduce-scatters and 257 all-reduces per step;
    zamba2-2.7B ``long_500k`` on (2, 2): 145 all-reduces and 173
    all-gathers per decode step — what tools/serve_torch_sharded.py
    counted on four H100s."""
    rank = D.RankStandIn(AXES, (2, 2))
    g = D.extrapolated(get_config("gemma2_9b"), "train_4k", rank,
                       torch.float32, "full", 1)["collectives"]["calls"]
    assert (g[ALL_GATHER], g[REDUCE_SCATTER], g[ALL_REDUCE]) == \
        (590, 295, 257)
    z = D.extrapolated(get_config("zamba2_2p7b"), "long_500k", rank,
                       torch.float32, "full", 1)["collectives"]["calls"]
    assert (z[ALL_REDUCE], z[ALL_GATHER], z[REDUCE_SCATTER]) == (145, 173, 0)


def test_standin_counts_where_a_grouped_mesh_counts():
    rank = D.RankStandIn(AXES, (2, 2))
    x = torch.ones(4, 6)
    assert rank.psum(x, None) is x                    # no axis: no call
    rank.psum(x, "model")
    assert rank.all_gather(x, "data", dim=1).shape == (4, 12)
    assert rank.all_gather(x).shape == (16, 6)
    assert rank.reduce_scatter(x, "model", dim=1).shape == (4, 3)
    assert rank.all_to_all(torch.ones(2, 3), "model").shape == (2, 3)
    assert rank.agree(True)
    one = D.RankStandIn(("islands",), (4,))
    one.ppermute(x, [(s, s) for s in range(4)])       # no transfer
    one.ppermute(x, [(s, (s + 1) % 4) for s in range(4)])
    c = rank.counts()
    assert c["calls"] == {ALL_REDUCE: 2, ALL_GATHER: 2, REDUCE_SCATTER: 1,
                          ALL_TO_ALL: 1, PPERMUTE: 0}
    assert c["by_group"]["mesh/all_gather:g4"] == [1, 96]
    assert one.counts()["calls"][PPERMUTE] == 1
    with pytest.raises(ValueError):
        rank.psum(x, "nodes")                         # an unknown axis


def test_live_bytes_peak_of_a_step():
    """The peak counts the storages made during the run (saved
    activations, the gradient), not those made before."""
    with FakeTensorMode():
        w = torch.randn(1000, 1000, requires_grad=True)
        x = torch.randn(64, 1000)
        live = D.LiveBytes()
        live.exclude([w, x])
        with live:
            y = (x @ w).relu() @ w
            y.sum().backward()
    assert live.peak >= 4 * 1000 * 1000 + 2 * 4 * 64 * 1000
    assert live.peak < 4 * (4 * 1000 * 1000)


def test_run_cell_writes_json_and_skips(tmp_path, capsys):
    """A cell's JSON (an inapplicable cell written as skipped); with
    ``--all`` the cells already written are not run again."""
    out = str(tmp_path)
    rec = D.run_cell("minicpm_2b", "long_500k", "1x4", out)
    assert rec["skipped"].startswith("long_500k needs sub-quadratic")
    assert json.loads((tmp_path / "minicpm_2b__long_500k__1x4.json")
                      .read_text()) == rec
    rec = D.run_cell("whisper_medium", "decode_32k", "single", out,
                     dtypes=("f32",))
    assert not rec["errors"] and rec["n_ranks"] == 256
    b = rec["bytes"]["f32"]
    assert b["caches"] > 0 and b["optimizer"] == 0 and b["fits"]
    assert rec["collectives"]["f32"]["calls"][ALL_REDUCE] > 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            path = tmp_path / f"{D.cell_tag(arch, shape, 'single')}.json"
            if not path.exists():
                path.write_text("{}")
    capsys.readouterr()
    assert D.main(["--all", "--out", out, "--mesh", "single"]) == 0
    printed = capsys.readouterr().out
    assert printed.count("[cached]") == len(ARCH_IDS) * len(SHAPES)


def test_depth_table_rows():
    rows = D.depth_table(["minicpm_2b"])      # (1, 4), (2, 2); bf16, f32
    assert [(r["mesh"], r["dtype"]) for r in rows] == [
        ("1x4", "bf16"), ("1x4", "f32"), ("2x2", "bf16"), ("2x2", "f32")]
    for r in rows:                       # minicpm-2B fits whole anywhere
        assert r["layers"] == r["of"] == 40
    assert rows[1]["bytes_full"] == 2 * rows[0]["bytes_full"]
