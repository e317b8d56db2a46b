"""BENCHMARK.json against the benchmark's contract, and cells resolved by
name from their files."""
import json
import re
import shutil

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"_dim$|_rank$|hidden|intermediate|latent|state|projection|"
                   r"head_size|expand|experts_per_tok")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(cfg)      # each with the value run
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) - {"workloads"} == (
            {"name", "unit", "better", "bound", "source"} if "bound" in m else
            {"name", "unit", "better", "source", "layer", "moves"})
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        listed = [e["name"] for e in BENCH[group]]
        assert len(listed) == len(set(listed))


def chips_faults(workloads: list, mesh_of) -> list:
    """Where ``workloads`` break the rule on chips: each cell asks for 1 or
    4, at most max(1, ⌊cells / 4⌋) ask for 4, and a four-chip cell's mesh
    (``mesh_of(cell)``, from its traffic) has extents whose product is 4."""
    faults = [w["name"] for w in workloads if w["chips"] not in (1, 4)]
    four = [w for w in workloads if w["chips"] == 4]
    if len(four) > max(1, len(workloads) // 4):
        faults.append(f"{len(four)} four-chip cells of {len(workloads)}")
    faults += [w["name"] for w in four
               if spec.mesh_fault(mesh_of(w), w["chips"])]
    return faults


def cells_with(*chips_and_meshes):
    """The benchmark's cells and made-up ones of (chips, mesh)."""
    cells = [dict(w, mesh=None) for w in BENCH["workloads"]]
    cells += [{"name": f"x{i}.score", "chips": c, "mesh": m}
              for i, (c, m) in enumerate(chips_and_meshes)]
    return cells


TP4 = {"data": 1, "model": 4}
ONE = (1, None)


@pytest.mark.parametrize("cells,ok", [
    (cells_with(), True),
    (cells_with((4, TP4)), True),
    (cells_with((4, {"data": 2, "model": 2})), True),
    (cells_with((4, TP4), ONE, ONE, ONE, (4, TP4)), True),
    (cells_with((2, {"model": 2})), False),
    (cells_with((4, TP4), (4, TP4)), False),
    (cells_with((4, TP4), ONE, ONE, (4, TP4)), False),
    (cells_with((4, {"data": 1, "model": 2})), False),
    (cells_with((4, None)), False),
])
def test_chips_rule(cells, ok):
    mesh = {w["name"]: w["mesh"] for w in cells}
    for w in BENCH["workloads"]:
        mesh[w["name"]] = spec.resolve(w["name"]).traffic.get("mesh")
    assert (chips_faults(cells, lambda w: mesh[w["name"]]) == []) is ok


@pytest.mark.parametrize("chips,mesh,ok", [
    (1, None, True), (4, TP4, True), (4, None, False),
    (4, {"data": 1, "model": 2}, False), (1, TP4, False),
    (4, {"data": 0, "model": 4}, False)])
def test_resolve_refuses_a_mesh_that_is_not_the_chips(tmp_path, chips, mesh,
                                                       ok):
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__"))
    traffic = spec.load_json(here / "traffic" / "score_b24_l2048.json")
    if mesh is not None:
        traffic["mesh"] = mesh
    (here / "traffic" / "score_x.json").write_text(json.dumps(traffic))
    cell = "minicpm-2b.score_x"
    (here / "limits" / f"{cell}.json").write_text('{"logits_gap": 1e-4}')
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": cell, "config": "minicpm-2b",
                               "traffic": "score_x", "chips": chips,
                               "why": "x"})
    if ok:
        assert spec.resolve(cell, bench, here).chips == chips
    else:
        with pytest.raises(ValueError, match="mesh"):
            spec.resolve(cell, bench, here)


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].startswith("mfu") or m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_e2e_and_a_layer(cell):
    c = spec.resolve(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:                 # each metric's `moves` is here
        assert m["moves"] in e2e


def test_every_config_keeps_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = spec.resolve(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.config["name"] == entry["config"]
    assert c.traffic == spec.load_json(
        spec.HERE / "traffic" / f"{entry['traffic']}.json")
    assert spec.loop_module(c.traffic).run
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(spec.metric_module(m["name"]).read)
    assert spec.family_module(c.config).spec(c.config)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.resolve("no-such-model.score_b32_l2048")


def test_a_new_cell_is_only_new_files_and_entries(tmp_path):
    """A configuration, a traffic mix, its limits and a metric added as
    files, and entries added to BENCHMARK.json: no file changes."""
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs" / "minicpm-2b.json").read_text())
    cfg["name"] = "minicpm-2b-d8"
    (here / "configs" / "minicpm-2b-d8.json").write_text(json.dumps(cfg))
    (here / "traffic" / "score_b1_l8192.json").write_text(json.dumps(
        {"loop": "score", "batch": 1, "seq_len": 8192, "pool": 16,
         "sample": 1, "trace_iters": 2}))
    cell = "minicpm-2b-d8.score_b1_l8192"
    (here / "limits" / f"{cell}.json").write_text('{"logits_gap": 1e-4}')
    (here / "metrics" / "attn_ms.score.py").write_text(
        "def read(r):\n    return None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "minicpm-2b-d8", "source": "x",
                             "file": "portbench/configs/minicpm-2b-d8.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell, "config": "minicpm-2b-d8",
                               "traffic": "score_b1_l8192", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append({"name": "attn_ms.score", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "score_tokens_per_s",
                               "workloads": [cell]})
    c = spec.resolve(cell, bench, here)
    assert c.traffic["seq_len"] == 8192 and c.config["name"] == "minicpm-2b-d8"
    assert [m["name"] for m in c.per_layer] == ["attn_ms.score"]
    assert [m["name"] for m in c.end_to_end] == ["score_tokens_per_s",
                                                 "setup_s"]
    assert spec.metric_module("attn_ms.score", here).read(None) is None
    assert all(p.read_bytes() == b for p, b in before.items())
