"""A whole run of each cell on the CPU at a tiny size, the chip's look
skipped: the port's run comes out correct, and the control (the plain
reference at TF32 in the port's place) and each fault planted in the
timed path (`faults`) come out not correct, with the cell's limits."""
import time

import pytest

from portbench import faults, harness
from portbench.tiny import tiny_cell

SCORE = ["hybrid-mamba2-2.3b.score_b32_l2048", "minicpm-2b.score_b24_l2048"]
TRAIN = ["minicpm-2b.train_b2_s2048"]
CASES = ([(c, m) for c in SCORE for m in ("program", "control", "half", "token")]
         + [(c, m) for c in TRAIN for m in ("program", "control", "half",
                                            "token", "unchanged")])


def run(cell, mode, trace=False):
    t = time.perf_counter()
    make = None if mode in ("program", "control") else faults.make(mode)
    return harness.run_cell(tiny_cell(cell), 2 ** 31 + 11, 0.05, trace, "cpu",
                            t, mode="program" if make else mode, make=make)


@pytest.mark.parametrize("cell,mode", CASES)
def test_correct_only_for_the_port(cell, mode):
    r = run(cell, mode)
    assert r["correct"] is (mode == "program"), r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())


@pytest.mark.parametrize("cell", SCORE + TRAIN)
def test_result_lines(cell):
    plain, traced = run(cell, "program"), run(cell, "program", trace=True)
    assert set(plain) == {"correct", "attempted", "failed", "metrics",
                          "device", "checks"}
    names = {m["name"] for m in tiny_cell(cell).end_to_end}
    assert set(plain["metrics"]) == names
    assert all(v["value"] > 0 for v in plain["metrics"].values())
    assert set(traced) == set(plain) | {"breakdown"}
    assert traced["metrics"] == {}          # no device: every reader is silent
    assert {"busy_s", "window_s"} <= set(traced["device"])
    lines = harness.check_lines(plain)
    assert len(lines) == len(plain["checks"]) and lines[0].startswith("check ")
