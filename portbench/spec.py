"""Resolve a cell of ``BENCHMARK.json`` into the files that define it.

A cell names a configuration and a traffic mix; each is a JSON file under
``configs/`` and ``traffic/``, the cell's limits are ``limits/<cell>.json``,
the traffic's ``loop`` names ``loops/<loop>.py`` and each per-layer
metric ``metrics/<name>.py``.  A cell of several chips takes its mesh
from its traffic's ``"mesh"``.  Nothing here imports torch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list          # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    names the cell, or it has none and (for a per-layer metric) the cell
    reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_names is None:
        return True
    return metric["moves"] in e2e_names


def resolve(name: str, bench: dict | None = None, here: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and
    metrics; raises KeyError for a cell the benchmark does not list."""
    bench = benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    fault = mesh_fault(traffic.get("mesh"), w["chips"])
    if fault:
        raise ValueError(f"{name}: {fault}")
    return Cell(name=name, chips=w["chips"],
                config=load_json(here / "configs" / f"{w['config']}.json"),
                traffic=traffic,
                limits=load_json(here / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def mesh_fault(mesh: dict | None, chips: int) -> str | None:
    """Why a cell of ``chips`` chips cannot run on the ``mesh`` its traffic
    names ({axis: extent}; none for one chip), or None: the extents are
    positive whole numbers whose product is ``chips``."""
    extents = list((mesh or {}).values())
    if not all(isinstance(e, int) and e >= 1 for e in extents):
        return f"mesh extents must be positive whole numbers: {mesh}"
    if math.prod(extents) != chips:
        return (f"the mesh {mesh or {}} holds {math.prod(extents)} rank(s), "
                f"the cell asks for {chips} chip(s)")
    return None


def load_module(path: Path):
    """Import the Python file ``path`` (its name may hold dots, as a
    metric's does) under a private module name."""
    mod_name = "portbench._file_" + hashlib.sha256(
        str(path.resolve()).encode()).hexdigest()[:16]
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def loop_module(traffic: dict, here: Path = HERE):
    return load_module(here / "loops" / f"{traffic['loop']}.py")


def metric_module(name: str, here: Path = HERE):
    return load_module(here / "metrics" / f"{name}.py")


def family_module(config: dict):
    """The plain reference of the configuration's family."""
    return importlib.import_module(f"portbench.reference.{config['family']}")
