"""Source-level lints: host syncs on the serve path, registry coverage
(port of ``repro/analysis/lint.py``; pure ``ast``, copied and widened).

**host_sync**: the serve hot loop must not synchronize with the device
except at designed sync points (the sampled token feeding Python-side slot
state).  An AST walk over ``src/repro_torch/serve/*.py`` flags, outside
the functions a module lists in its ``_HOST_SYNC_OK`` marker:

  * anywhere: ``.item()``, ``.block_until_ready()`` (the reference's
    forms) and torch's ``.cpu()``, ``.numpy()``, ``.tolist()`` and
    ``torch.cuda.synchronize()`` — ``sync-<name>``;
  * inside ``for``/``while`` bodies: device→host materialisation —
    ``np.asarray``/``jax.device_get``/``np.array`` (the reference's forms)
    and ``int(...)``/``bool(...)`` of anything but a literal or a name
    bound to a Python value — ``materialize-in-loop``.

Host syncs inside the device programs are what the op trace finds at run
time (`checkers.check_hygiene`), so this lint only needs the eager glue.

**registry**: every public driver in `core/interface.py` must map to at
least one registered entry point via `registry.DRIVER_ENTRIES` — new
drivers cannot silently opt out of analysis.
"""
from __future__ import annotations

import ast
import os
from typing import List, Optional

from repro_torch.analysis.findings import Finding

_SYNC_ATTRS = ("item", "block_until_ready", "cpu", "numpy", "tolist")
_MATERIALIZE = ("asarray", "device_get", "array")
_SCALAR_CASTS = ("int", "bool")


def _marker_names(tree: ast.Module) -> tuple:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "_HOST_SYNC_OK":
                    try:
                        return tuple(ast.literal_eval(node.value))
                    except ValueError:
                        return ()
    return ()


def _is_cuda_sync(fn: ast.AST) -> bool:
    """``torch.cuda.synchronize`` (or ``cuda.synchronize``)."""
    return (isinstance(fn, ast.Attribute) and fn.attr == "synchronize"
            and isinstance(fn.value, ast.Attribute)
            and fn.value.attr == "cuda")


def _python_value(node: ast.AST) -> bool:
    """An argument of int()/bool() that holds no tensor: a literal, a
    ``len(...)``, or arithmetic of those."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id == "len"
    if isinstance(node, ast.BinOp):
        return _python_value(node.left) and _python_value(node.right)
    return False


class _ServeLinter(ast.NodeVisitor):
    def __init__(self, relpath: str, allowed: tuple):
        self.relpath = relpath
        self.allowed = allowed
        self.fn_stack: List[str] = []
        self.loop_depth = 0
        self.findings: List[Finding] = []

    def _in_allowed(self) -> bool:
        return any(fn in self.allowed for fn in self.fn_stack)

    def visit_FunctionDef(self, node):
        self.fn_stack.append(node.name)
        outer_loops = self.loop_depth
        self.loop_depth = 0
        self.generic_visit(node)
        self.loop_depth = outer_loops
        self.fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _loop
    visit_While = _loop

    def _sync(self, name: str, loc: str) -> None:
        self.findings.append(Finding(
            checker="host_sync", severity="error", entry="serve",
            code=f"sync-{name}", location=loc,
            message=f"{name} on the serve path at {loc} — a blocking device "
                    f"sync outside the designed sync points "
                    f"(_HOST_SYNC_OK)"))

    def _materialize(self, name: str, loc: str) -> None:
        self.findings.append(Finding(
            checker="host_sync", severity="warning", entry="serve",
            code="materialize-in-loop", location=loc,
            message=f"{name}(...) inside a serve loop at {loc} — "
                    f"device→host materialisation per iteration; add the "
                    f"function to _HOST_SYNC_OK if this is a designed sync "
                    f"point"))

    def visit_Call(self, node):
        fn = node.func
        loc = f"{self.relpath}:{node.lineno}"
        if not self._in_allowed():
            if _is_cuda_sync(fn):
                self._sync("synchronize", loc)
            elif isinstance(fn, ast.Attribute) and fn.attr in _SYNC_ATTRS:
                self._sync(fn.attr, loc)
            elif self.loop_depth > 0:
                if isinstance(fn, ast.Attribute) and fn.attr in _MATERIALIZE:
                    self._materialize(f".{fn.attr}", loc)
                elif (isinstance(fn, ast.Name) and fn.id in _SCALAR_CASTS
                      and node.args
                      and not all(_python_value(a) for a in node.args)):
                    self._materialize(fn.id, loc)
        self.generic_visit(node)


def _serve_dir() -> str:
    import repro_torch.serve as S
    return os.path.dirname(os.path.abspath(S.__file__))


def check_host_sync(serve_dir: Optional[str] = None) -> List[Finding]:
    serve_dir = serve_dir or _serve_dir()
    findings: List[Finding] = []
    for fname in sorted(os.listdir(serve_dir)):
        if not fname.endswith(".py"):
            continue
        path = os.path.join(serve_dir, fname)
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        linter = _ServeLinter(f"serve/{fname}", _marker_names(tree))
        linter.visit(tree)
        findings.extend(linter.findings)
    return findings


def check_driver_registry(driver_entries: Optional[dict] = None,
                          registry: Optional[dict] = None) -> List[Finding]:
    import inspect
    from repro_torch.core import interface
    from repro_torch.analysis import registry as reg
    driver_entries = (reg.DRIVER_ENTRIES if driver_entries is None
                      else driver_entries)
    registry = reg.default_registry() if registry is None else registry
    findings: List[Finding] = []
    for name in sorted(dir(interface)):
        fn = getattr(interface, name)
        if (name.startswith("_") or not inspect.isfunction(fn)
                or fn.__module__ != interface.__name__):
            continue
        entries = driver_entries.get(name)
        if not entries:
            findings.append(Finding(
                checker="registry", severity="error", entry=name,
                code="driver-unregistered", location=f"interface.{name}",
                message=f"public driver {name} has no entry in "
                        f"analysis.registry.DRIVER_ENTRIES — register a "
                        f"canonical instance so it cannot opt out of "
                        f"analysis"))
            continue
        for ename in entries:
            if ename not in registry:
                findings.append(Finding(
                    checker="registry", severity="error", entry=name,
                    code="driver-dangling-entry",
                    location=f"interface.{name}",
                    message=f"driver {name} maps to unknown analysis "
                            f"entry {ename!r}"))
    return findings
