"""A cell of four chips on the CPU: four gloo ranks through the launch
path of ``ranks.py`` on the tiny minicpm at (data 1, model 4); each rank's
blocks of the weights drawn one group at a time against the blocks of
the whole draw; the reference on weights drawn as it reads them against
the whole draw."""
import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from portbench import ranks, sut
from portbench.reference import common as C
from portbench.reference import dense
from portbench.tiny import tiny_cell

SEED = 2 ** 31 + 77
#: name → (fault, traced, collective timeout in seconds)
RUNS = {"program": (None, False, 300), "token": ("token", True, 300),
        "raise": ("raise", False, 300), "stall": ("stall", False, 8)}


def four_chip_cell():
    c = tiny_cell("minicpm-2b.score_b24_l2048")
    return dataclasses.replace(
        c, name="minicpm-2b.score_tp4", chips=4,
        traffic=dict(c.traffic, mesh={"data": 1, "model": 4}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of `RUNS` at once: (codes, out, err, seconds, run dir)."""
    cell = four_chip_cell()
    base = tmp_path_factory.mktemp("ranks")

    def go(name):
        fault, traced, timeout = RUNS[name]
        t = time.perf_counter()
        codes, out, err = ranks.launch(cell, SEED, 0.05, traced, "cpu", t,
                                       base / name, fault=fault,
                                       collective_timeout=timeout)
        return name, (codes, out, err, time.perf_counter() - t, base / name)

    with ThreadPoolExecutor(len(RUNS)) as pool:
        return dict(pool.map(go, RUNS))


def result(run):
    codes, out, err, _, _ = run
    assert codes == [0, 0, 0, 0], err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def test_four_ranks_give_one_result_line(runs):
    r = result(runs["program"])
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 24
    assert r["device"]["count"] == 4
    assert set(r["metrics"]) == {"score_tokens_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    gap = r["checks"]["logits_gap"]
    assert gap["limit"] == 1e-4 and 0 < gap["value"] < gap["limit"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    run_dir = runs["program"][4]
    assert all((run_dir / f"rank{k}.out").read_text() == "" for k in (1, 2, 3))
    err = runs["program"][2].strip().splitlines()
    assert err[-1].startswith("check logits_gap ")
    assert [ln.split(":")[0] for ln in err[:4]] == [f"rank {k}" for k in range(4)]


def test_a_fault_on_four_ranks_is_not_correct(runs):
    r = result(runs["token"])
    assert r["correct"] is False and r["device"]["count"] == 4
    assert r["checks"]["logits_gap"]["value"] > 1e-2
    assert r["metrics"] == {}                 # traced: no device to read
    assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r


@pytest.mark.parametrize("name", ["raise", "stall"])
def test_a_failing_rank_ends_the_run(runs, name):
    codes, out, err, seconds, _ = runs[name]
    assert out == "" and any(codes)
    assert seconds < 90
    if name == "raise":
        assert codes[1] == 1 and "a fault planted on rank 1" in err
    else:                           # the others timed out; rank 1 was killed
        assert codes[1] < 0 and "Timed out" in err


def blocks_of(cfg, spec, whole, rank):
    from repro_torch.launch.dryrun import RankStandIn
    mesh = RankStandIn(("data", "model"), (1, 4), rank=rank)
    drawn = sut.rank_weights(cfg, spec, 3, "cpu", mesh)
    keep = sut.T.tp_keeper(sut.port_config(cfg), mesh)
    return drawn, {n: keep(n, t) for n, t in whole.items()}


def test_each_rank_holds_the_blocks_of_the_whole_draw():
    cfg = four_chip_cell().config
    spec = dense.spec(cfg)
    whole = C.draw(spec, 3, "cpu")
    held = []
    for rank in range(4):
        drawn, cut = blocks_of(cfg, spec, whole, rank)
        assert set(drawn) == set(whole)
        assert all(torch.equal(drawn[n], cut[n]) for n in whole)
        # each block owns its storage: no group's buffer stays alive
        assert all(t.untyped_storage().nbytes() == t.numel() * 4
                   for t in drawn.values())
        held.append(drawn)
    for name, t in whole.items():             # the blocks make the leaf
        parts = [h[name] for h in held]
        split = [d for d in range(t.dim()) if parts[0].shape[d] != t.shape[d]]
        if not split:
            assert all(torch.equal(p, t) for p in parts), name
        else:
            assert torch.equal(torch.cat(parts, split[0]), t), name
    assert sum(held[0][n].numel() for n in whole) < \
        0.3 * sum(t.numel() for t in whole.values())


def test_streamed_reference_is_the_whole_draws_bit_for_bit():
    cfg = four_chip_cell().config
    spec = dense.spec(cfg)
    tokens = C.token_pool(5, 1, 2, 24, cfg["vocab"], "cpu")[0]
    streamed = C.Streamed(spec, 5, "cpu")
    ours = dense.forward(streamed, cfg, tokens)
    assert torch.equal(ours, dense.forward(C.draw(spec, 5, "cpu"), cfg, tokens))
    # embed, each layer, the final norm, and embed again for the tied head
    assert streamed.draws == cfg["n_layers"] + 3
    assert set(streamed) == {row[1] for row in spec}
    assert len(streamed._held) < len(spec) // 2


def test_the_control_of_a_four_chip_cell_runs_in_one_process():
    from portbench import harness
    r = harness.run_cell(four_chip_cell(), SEED, 0.05, False, "cpu",
                         time.perf_counter(), mode="control")
    assert r["correct"] is False and r["device"]["count"] == 1
    assert r["checks"]["logits_gap"]["value"] > 1e-4


def test_the_train_loop_runs_on_one_chip():
    from portbench import spec
    c = tiny_cell("minicpm-2b.train_b2_s2048")
    ctx = type("Ctx", (), {"world": 4, "cell": c})()
    with pytest.raises(ValueError, match="one chip"):
        spec.loop_module(c.traffic).run(ctx)
