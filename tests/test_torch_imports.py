"""Import hygiene: `repro_torch`, chip_smoke.py, the port's profiling
and 4-card tools and its examples (`examples/*_torch.py`) import neither
jax nor the JAX package `repro`, so the port installs
and runs without them: a tiny kaffpa, a tiny kahypar, a tiny node
separator and ordering, the memetic programs (kaffpaE, KaBaPE, kahyparE,
the memetic separator), process mapping and the ILP improvement, reduced
zamba2, rwkv6 and whisper forwards and one served request each, a train
step, a checkpoint round trip and pipeline stages run with both blocked,
and so do the quickstart (file formats, a recorded kaffpa written as a
Chrome trace), the serving example (telemetry, the traffic hypergraph
through kahypar) and the training example, on the CPU.
`core.mesh` imports ``torch.distributed`` only where a process group is
used, so ``import repro_torch`` and the distributed programs on a world
of one (parhip, parhyp, the distributed edge partition, a ring roll, a
MoE decoder under ``shardings.use_mesh`` of a local mesh) run with it
blocked too."""
import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_imports_in_source():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_kaffpa.py",
        ROOT / "tools" / "serve_torch_sharded.py"] + EXAMPLES
    assert len(files) > 25 and len(EXAMPLES) == 5
    assert PORT / "core" / "hypergraph" / "refine.py" in files
    assert PORT / "core" / "nodesep" / "refine.py" in files
    for new in (("core", "memetic", "driver.py"),
                ("core", "memetic", "migrate.py"),
                ("core", "memetic", "state.py"), ("core", "evolve.py"),
                ("core", "kabape.py"), ("core", "mapping.py"),
                ("core", "ilp.py"), ("launch", "topology.py"),
                ("core", "mesh.py"), ("core", "parhip.py"),
                ("core", "hypergraph", "dist.py"), ("models", "rwkv6.py"),
                ("train", "train_step.py"), ("train", "optimizer.py"),
                ("train", "checkpoint.py"), ("train", "data.py"),
                ("train", "fault.py"), ("train", "pipeline.py"),
                ("models", "shardings.py"), ("launch", "mesh.py"),
                ("launch", "ranks.py"), ("obs", "trace.py"),
                ("obs", "live.py"), ("io", "binio.py"),
                ("analysis", "__init__.py"), ("analysis", "__main__.py"),
                ("analysis", "checkers.py"), ("analysis", "findings.py"),
                ("analysis", "lint.py"), ("analysis", "padding.py"),
                ("analysis", "registry.py"), ("analysis", "spmd.py"),
                ("analysis", "tracing.py"), ("launch", "dryrun.py")):
        assert PORT.joinpath(*new) in files, new
    for f in files:
        bad = {m for m in _imported_roots(f)} & {"jax", "jaxlib", "repro"}
        assert not bad, (f, bad)


def test_port_runs_with_jax_and_reference_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None        # any import of them now fails
        sys.modules["repro"] = None
        import importlib, pkgutil
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch.core import interface
        from repro_torch.io.generators import grid2d
        g = grid2d(10, 10)
        cut, part = interface.kaffpa(g.n, None, g.xadj, None, g.adjncy, 2,
                                     0.03, seed=1, device="cpu")
        assert 0 < cut < 40 and len(part) == g.n
        from repro_torch.io.generators import planted_hypergraph
        hg = planted_hypergraph(60, 90, blocks=2, seed=1)
        km1, hpart = interface.kahypar(hg.n, hg.m, None, None, hg.eptr,
                                       hg.eind, 2, 0.05, seed=1,
                                       device="cpu")
        assert 0 < km1 < 90 and len(hpart) == hg.n
        nsep, sep = interface.node_separator(g.n, None, g.xadj, None,
                                             g.adjncy, 2, 0.2, seed=1,
                                             device="cpu")
        assert 0 < nsep == len(sep) <= 12
        inv = interface.reduced_nd(g.n, g.xadj, g.adjncy, seed=1,
                                   device="cpu")
        assert sorted(inv) == list(range(g.n))
        ecut, epart = interface.kaffpaE(g.n, None, g.xadj, None, g.adjncy,
                                        2, 0.03, seed=1, n_islands=2,
                                        population=2, generations=1,
                                        device="cpu")
        assert 0 < ecut <= cut
        from repro_torch.core.kabape import kabapeE
        from repro_torch.core.partition import is_feasible
        assert is_feasible(g, kabapeE(g, 4, 0.0, n_islands=1, population=2,
                                      generations=1, seed=1, device="cpu"),
                           4, 0.0)
        ekm1, _ = interface.kahyparE(hg.n, hg.m, None, None, hg.eptr,
                                     hg.eind, 2, 0.05, seed=1,
                                     generations=1, device="cpu")
        assert 0 < ekm1 <= km1
        msep, _ = interface.node_separator(g.n, None, g.xadj, None,
                                           g.adjncy, 2, 0.2, seed=1,
                                           memetic=True, time_limit=0,
                                           device="cpu")
        assert 0 < msep <= nsep
        pcut, qap, final = interface.process_mapping(
            g.n, None, g.xadj, None, g.adjncy, [2, 2], [1, 10], 2, 0.03,
            seed=1, device="cpu")
        assert pcut > 0 and qap >= 0 and sorted(set(final)) == [0, 1, 2, 3]
        from repro_torch.core.ilp import ilp_improve
        from repro_torch.core.partition import edge_cut
        assert edge_cut(g, ilp_improve(g, final, 4, timeout=5)) <= pcut
        from repro_torch.launch import topology
        assert topology.choose_axis_assignment(
            {"data": 1.0e6}, {"data": 4}, hierarchy=(2, 2),
            distances=(1, 10), device="cpu")["qap"] >= 0
        import torch
        from repro_torch.configs.base import get_config
        from repro_torch.models import transformer as T
        from repro_torch.serve.batching import serve_requests
        cfg = get_config("zamba2_2p7b").reduced()
        model = T.init_params(cfg, 0, device="cpu")
        logits, _ = model(torch.zeros(1, 5, dtype=torch.long))
        assert logits.shape == (1, 5, cfg.vocab_pad)
        (req,) = serve_requests(model, cfg, [[1, 2, 3]], batch_slots=2,
                                max_len=16, max_new=3)
        assert req.done and len(req.out) == 3
        for arch in ("rwkv6_7b", "whisper_medium"):
            cfg = get_config(arch).reduced()
            model = T.init_params(cfg, 0, device="cpu")
            frames = (torch.ones(1, cfg.enc_positions, cfg.d_model)
                      if cfg.enc_layers else None)
            logits, _ = model(torch.zeros(1, 5, dtype=torch.long),
                              enc_frames=frames)
            assert logits.shape == (1, 5, cfg.vocab_pad)
            (req,) = serve_requests(model, cfg, [[1, 2, 3]], batch_slots=2,
                                    max_len=16, max_new=3)
            assert req.done and len(req.out) == 3
        import tempfile
        from repro_torch.train import checkpoint
        from repro_torch.train.data import DataConfig, batches
        from repro_torch.train.optimizer import OptConfig
        from repro_torch.train.pipeline import partition_layers
        from repro_torch.train.train_step import (init_opt_state,
                                                  make_train_step)
        cfg = get_config("minicpm_2b").reduced()
        model = T.init_params(cfg, 0, device="cpu")
        opt = init_opt_state(model, grad_compress=True)
        step = make_train_step(cfg, OptConfig(), grad_compress=True,
                               microbatches=2)
        data = batches(DataConfig(cfg.vocab, 8, 2), device="cpu")
        model, opt, m = step(model, opt, next(data))
        assert torch.isfinite(m["loss"]) and int(opt["step"]) == 1
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save(d, 1, (model, opt))
            fresh = T.init_params(cfg, 1, device="cpu")
            checkpoint.restore(d, (fresh, init_opt_state(fresh, True)))
            assert torch.equal(fresh.embed, model.embed)
        stage = partition_layers(get_config("minicpm_2b"), 4, device="cpu")
        assert sorted(set(stage.tolist())) == [0, 1, 2, 3]
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k in sys.modules if sys.modules[k] is not None)
        print("ok", cut)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_analysis_and_dry_run_run_with_jax_and_reference_blocked(tmp_path):
    """``python -m repro_torch.analysis --device cpu`` (the tiny driver
    runs, every registry entry, both lints) exits 0 with zero findings,
    and a dry-run cell is written, with jax and `repro` blocked."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None        # any import of them now fails
        sys.modules["repro"] = None
        import runpy
        sys.argv = ["repro_torch.analysis", "--device", "cpu", "--out",
                    {str(tmp_path / "findings.jsonl")!r}]
        try:
            runpy.run_module("repro_torch.analysis", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        from repro_torch.launch import dryrun
        rec = dryrun.run_cell("minicpm_2b", "decode_32k", "1x4",
                              {str(tmp_path)!r}, dtypes=("f32",))
        assert not rec["errors"] and rec["bytes"]["f32"]["caches"] > 0
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k in sys.modules if sys.modules[k] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 findings" in out.stdout and out.stdout.rstrip().endswith("ok")
    assert (tmp_path / "minicpm_2b__decode_32k__1x4.json").exists()


def test_torch_distributed_is_imported_only_where_a_group_is_used():
    """No port module imports ``torch.distributed`` at its top level."""
    for f in sorted(PORT.rglob("*.py")):
        tree = ast.parse(f.read_text())
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [f"{node.module}.{a.name}" for a in node.names]
                     if isinstance(node, ast.ImportFrom) and node.module
                     else [])
            assert not any(n.startswith("torch.distributed")
                           for n in names), (f, names)


def test_world_of_one_runs_without_torch_distributed():
    code = textwrap.dedent("""
        import sys
        import torch
        sys.modules["torch.distributed"] = None   # importing it now fails
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import importlib, pkgutil
        import numpy as np
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch.core import interface, memetic
        from repro_torch.core.edgepart import distributed_edge_partition
        from repro_torch.core.mesh import Mesh
        from repro_torch.core.parhip import parhip
        from repro_torch.core.partition import is_feasible
        from repro_torch.io.generators import grid2d, planted_hypergraph
        g = grid2d(10, 10)
        assert is_feasible(g, parhip(g, 2, 0.03, seed=1, device="cpu"), 2,
                           0.03)
        ep = distributed_edge_partition(g, 2, seed=1, device="cpu")
        assert ep.shape == (g.m,)
        hg = planted_hypergraph(60, 90, blocks=2, seed=1)
        km1, part = interface.parhyp(hg.n, hg.m, None, None, hg.eptr,
                                     hg.eind, 2, 0.05, seed=1, device="cpu")
        assert 0 < km1 < 90 and len(part) == hg.n
        mesh = Mesh.local(("islands",), device="cpu")
        parts = np.arange(6, dtype=np.int32).reshape(3, 2)
        assert (memetic.ring_roll(parts, 1, mesh) == np.roll(parts, 1, 0)
                ).all()
        import torch
        from repro_torch.configs.base import get_config
        from repro_torch.models import shardings as SH
        from repro_torch.models import transformer as T
        cfg = get_config("llama4_scout_17b_a16e").reduced()
        local = Mesh.local(("data", "model"), device="cpu")
        model = T.init_params(cfg, 0, mesh=local)
        toks = torch.zeros(2, 8, dtype=torch.long)
        with torch.no_grad():
            want = T.forward(model, cfg, toks)[0]
            with SH.use_mesh(local):
                assert torch.equal(T.forward(model, cfg, toks)[0], want)
        print("ok", km1)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_four_families_under_a_local_mesh_run_with_jax_and_reference_blocked():
    """The tensor-parallel code paths of the hybrid, MLA, audio and ssm
    families (`shardings.tp_rmsnorm`, the segment splits, the gathered
    receptance, the batcher on a mesh) at a ``model`` extent of 1, with
    jax, `repro` and ``torch.distributed`` blocked: a forward, a decode
    step and a served request each, equal to no mesh."""
    code = textwrap.dedent("""
        import sys
        import torch
        sys.modules["torch.distributed"] = None
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        from repro_torch.configs.base import get_config
        from repro_torch.core.mesh import Mesh
        from repro_torch.models import shardings as SH
        from repro_torch.models import transformer as T
        from repro_torch.serve.batching import serve_stream
        from repro_torch.serve.serve_step import decode_step, prefill_step
        local = Mesh.local(("data", "model"), device="cpu")
        for arch in ("zamba2_2p7b", "deepseek_v2_236b", "whisper_medium",
                     "rwkv6_7b"):
            cfg = get_config(arch).reduced()
            model = T.init_params(cfg, 0, mesh=local)
            toks = torch.arange(12).reshape(2, 6) % cfg.vocab
            fr = (torch.ones(2, cfg.enc_positions, cfg.d_model) * 0.1
                  if cfg.enc_layers else None)
            runs = []
            for mesh in (None, local):
                with torch.no_grad(), SH.use_mesh(mesh):
                    lg = T.forward(model, cfg, toks, enc_frames=fr)[0]
                    c = T.init_caches(cfg, 2, 8, device="cpu", mesh=mesh)
                    last, _ = prefill_step(model, cfg, toks[:, :5], c,
                                           enc_frames=fr)
                    step, _ = decode_step(model, cfg, toks[:, 5:], c, 5)
                reqs = serve_stream(model, cfg, [(0, [1, 2], 2)],
                                    batch_slots=1, max_len=8, mesh=mesh)
                runs.append((lg, last, step, reqs[0].out))
            (a, b) = runs
            assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
            assert a[3] == b[3] and len(a[3]) == 2, arch
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_examples_run_with_jax_and_reference_blocked(tmp_path):
    """The quickstart, serving and training examples run on the CPU with
    jax and `repro` blocked (the other two are imported); each writes
    only under its ``--out`` / ``--ckpt`` directory."""
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        ex = {str(ROOT / "examples")!r}
        runs = {{
            "quickstart_torch": ["--cpu", "--out", {str(tmp_path / "q")!r}],
            "serve_lm_torch": ["--cpu", "--out", {str(tmp_path / "s")!r}],
            "train_lm_torch": ["--cpu", "--steps", "3", "--dim", "64",
                               "--layers", "2", "--seq", "16", "--batch",
                               "2", "--ckpt", {str(tmp_path / "c")!r}],
        }}
        for name in ("hypergraph_partition_torch",
                     "partition_and_map_torch"):
            runpy.run_path(f"{{ex}}/{{name}}.py", run_name="imported")
        for name, argv in runs.items():
            sys.argv = [name] + argv
            runpy.run_path(f"{{ex}}/{{name}}.py", run_name="__main__")
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k in sys.modules if sys.modules[k] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("ok")
    assert "recorded run: edgecut=" in out.stdout
    assert "kahypar (λ-1)" in out.stdout and "done: {'restarts': 0" \
        in out.stdout
    trace = json.loads((tmp_path / "q" / "quickstart_trace.json").read_text())
    assert any(e["name"] == "multilevel" for e in trace["traceEvents"])
    serve = json.loads((tmp_path / "s" / "serve_trace.json").read_text())
    tracks = {e["args"]["name"] for e in serve["traceEvents"]
              if e["ph"] == "M"}
    assert {"slot 0", "slot 1", "slot 2", "queue"} <= tracks
    assert sorted(p.name for p in (tmp_path / "q").iterdir()) == sorted([
        "quickstart.graph", "quickstart.bin", "quickstart.ext.bin",
        "tmppartition4", "tmppartition4.bin", "quickstart_trace.json"])
