"""Import hygiene: `repro_torch`, chip_smoke.py and the port's profiling
tool import neither jax nor the JAX package `repro`, so the port installs
and runs without them: a tiny kaffpa and a tiny kahypar run with both
blocked."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_imports_in_source():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_kaffpa.py"]
    assert len(files) > 25
    assert PORT / "core" / "hypergraph" / "refine.py" in files
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
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k in sys.modules if sys.modules[k] is not None)
        print("ok", cut)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
