"""Port parity: `repro_torch.analysis` — the contract checks on the port's
device programs — against `repro.analysis` where both have the piece.

The reference's checkers run on jaxprs (``analyze_entry``,
``check_padding``'s ``jax.core.jaxpr_as_fun``), which this jax cannot
evaluate, so the port is held to the reference's *inputs* instead: the
reference's canonical instances, its noise draws and its own padding
perturbations (``registry._perturb_*`` at seed ``0xA11A``) go through
both packages, and the port's projected outputs equal the reference's
eager outputs bit for bit, with and without garbage in the padding.
Each checker of the port flags a planted fault: padding that leaks into
an output, a host read in a loop, a float64 op, a Φ that skips its psum
over ``nets`` (on 4 gloo ranks, `tests/torch_ranks.py::rank_spmd`), a
serve file with host syncs, a driver missing from the registry.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.analysis import findings as rF
from repro.analysis import registry as rREG
from repro.core import csr as rcsr
from repro.core import lp as rlp

from repro_torch import obs
from repro_torch.analysis import (analyze, analyze_entry, checkers,
                                  exercise_drivers, lint,
                                  padding, registry as REG, tracing)
from repro_torch.analysis.findings import (Finding, load_baseline,
                                           partition_by_baseline,
                                           write_findings_jsonl)
from repro_torch.core import csr as tcsr
from repro_torch.core.hypergraph import container as tC

sys.path.insert(0, str(Path(__file__).parent))
import torch_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
A11A = 0xA11A


def T(a):
    return torch.from_numpy(np.array(a))


def _codes(found):
    return sorted(f.code for f in found)


# the 4 gloo ranks of the spmd check start with the module and run beside
# the other tests; `test_spmd_on_four_ranks` collects them
_SPMD: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _spmd_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd")

    def run():
        try:
            _SPMD["out"] = torch_ranks.run_ranks("rank_spmd", 4, tmp)
        except Exception as exc:  # noqa: BLE001 — re-raised by the test
            _SPMD["error"] = exc

    th = threading.Thread(target=run)
    th.start()
    _SPMD["thread"] = th
    yield
    th.join()


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------

def _pair_findings(mod):
    return [mod.Finding(checker="padding", severity="error", entry="e",
                        code="c", location="l", message="m",
                        detail={"x": 1}),
            mod.Finding(checker="spmd", severity="warning", entry="e2",
                        code="c2", location="l2", message="m2")]


def test_findings_jsonl_matches_reference(tmp_path):
    ours, ref = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    write_findings_jsonl(str(ours), _pair_findings(
        __import__("repro_torch.analysis.findings", fromlist=["Finding"])))
    rF.write_findings_jsonl(str(ref), _pair_findings(rF))
    a = [json.loads(x) for x in ours.read_text().splitlines()]
    b = [json.loads(x) for x in ref.read_text().splitlines()]
    assert a == b
    headers, events = obs.read_jsonl(str(ours))
    assert headers[0]["counters"] == {"analysis/padding": 1,
                                      "analysis/spmd": 1}
    assert [e["key"] for e in events] == [f.key for f in
                                          _pair_findings(rF)]


def test_partition_by_baseline_matches_reference(tmp_path):
    f = Finding(checker="padding", severity="error", entry="e", code="c",
                location="l", message="m")
    g = rF.Finding(checker="padding", severity="error", entry="e",
                   code="c", location="l", message="m")
    base = tmp_path / "base.json"
    base.write_text(json.dumps(
        {"version": 1, "allow": [{"key": f.key, "reason": "known"}]}))
    assert load_baseline(str(base)) == rF.load_baseline(str(base))
    new, allowed = partition_by_baseline([f], load_baseline(str(base)))
    rnew, rallowed = rF.partition_by_baseline([g],
                                              rF.load_baseline(str(base)))
    assert (len(new), len(allowed)) == (len(rnew), len(rallowed)) == (0, 1)
    assert partition_by_baseline([f], load_baseline(str(base) + ".no")) \
        == ([f], [])


# ---------------------------------------------------------------------------
# padding: the kernel entries under the reference's own perturbation
# ---------------------------------------------------------------------------

def _ref_eager(fn, args):
    with jax.disable_jit():
        return fn(*args)


def _real_rows(n):
    """The real vertices' rows of a one-array output.  (The reference's
    own projections of its one-array kernel entries, ``outs[0][:n]``,
    keep only vertex 0's row: they index the array, not a tuple.)"""
    return lambda out: [np.asarray(out)[:n]]


_KERNELS = {
    # reference builder, its perturbation, the projection of its output
    "kernels/lp_affinity": (rREG._build_lp_affinity,
                            rREG._perturb_lp_affinity,
                            _real_rows(REG.RING_N)),
    "kernels/sep_affinity": (rREG._build_sep_affinity,
                             rREG._perturb_sep_affinity,
                             _real_rows(REG.RING_N)),
    "kernels/pin_count": (rREG._build_pin_count, rREG._perturb_pin_count,
                          rREG.default_registry()[
                              "kernels/pin_count"].padding.project),
    "kernels/pin_affinity": (rREG._build_pin_affinity,
                             rREG._perturb_pin_affinity,
                             _real_rows(REG.HG_N)),
}


@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_kernel_entry_bit_identical_under_reference_perturbation(name):
    """Each kernel entry (the plain version on the CPU) on the reference's
    instance, clean and under the reference's perturbation: the real
    slots equal the reference's Pallas kernel (interpret mode) bit for
    bit, and each other."""
    build, perturb, rproj = _KERNELS[name]
    rfn, rargs = build()
    pentry = REG.default_registry()[name]
    pfn, _ = pentry.build(CPU)
    outs = []
    for args in (rargs, perturb(rargs, np.random.default_rng(A11A))):
        want = rproj(_ref_eager(rfn, args))
        port_args = [T(a) for a in args]
        port_args[-1] = port_args[-1][None]          # one row of labels
        got = pentry.padding.project(pfn(*port_args))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], np.asarray(w))
        outs.append(got)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_pin_count_csr_entry_equals_reference_ell_counts():
    """``ops.pin_count_csr`` (the port's kahypar call, no reference entry)
    on its garbled pin list gives the reference's ELL pin counts."""
    rfn, rargs = rREG._build_pin_count()
    rcnt = np.asarray(_ref_eager(rfn, rargs)[0])[:REG.HG_M]
    entry = REG.default_registry()["kernels/pin_count_csr"]
    fn, args = entry.build(CPU)
    for a in (args, entry.padding.perturb(args, np.random.default_rng(A11A))):
        got = entry.padding.project(fn(*a))[0]
        want = np.stack([np.asarray(_ref_eager(rfn, rargs[:3] + (
            np.asarray(a[3][i]),))[0])[:REG.HG_M] for i in range(2)])
        np.testing.assert_array_equal(got, want)
    # row 0's labels are the reference builder's
    np.testing.assert_array_equal(got[0], rcnt)


def _port_coo(rcoo):
    return tcsr.CooGraph(T(rcoo.src), T(rcoo.dst), T(rcoo.w), T(rcoo.vwgt))


def test_kway_lp_round_entry_bit_identical_under_reference_perturbation():
    """One k-way round on the ELL route against the reference's COO round,
    each row drawn as the reference draws it, on the ring graph and on
    the reference's garbled COO and ELL (`_perturb_coo`,
    `_perturb_ell`)."""
    entry = REG.default_registry()["engine/kway_lp_round"]
    fn, args = entry.build(CPU)
    _, labs, sizes, cap, _, _ = args
    g = rREG._ring_graph()
    rcoo = rcsr.to_coo(g)
    rell = rcsr.to_ell(g, row_tile=rcoo.n_pad)
    k = REG.KWAY_K
    keys = jax.random.split(jax.random.PRNGKey(11), labs.shape[0])
    noise = np.stack([np.asarray(jax.random.uniform(
        kk, (rcoo.n_pad, k), jnp.float32, 0.0, rlp._NOISE)) for kk in keys])
    rng = np.random.default_rng(A11A)
    cases = [(rcoo, rell),
             (rREG._perturb_coo(rcoo, rng), rREG._perturb_ell(rell, rng))]
    got_all = []
    for c, e in cases:
        got = entry.padding.project(fn(
            _port_coo(c), labs, sizes, cap, T(noise),
            tcsr.EllGraph(T(e.nbr), T(e.wgt), T(e.vwgt))))
        for i in range(labs.shape[0]):
            wl, ws = rlp.kway_lp_round(
                c, jnp.asarray(labs[i].numpy()), jnp.asarray(sizes[i].numpy()),
                jnp.asarray(cap.numpy()), keys[i], k, jnp.int32(1), None,
                False, False)
            np.testing.assert_array_equal(got[0][i],
                                          np.asarray(wl)[:REG.RING_N])
            np.testing.assert_array_equal(got[1][i], np.asarray(ws))
        got_all.append(got)
    for a, b in zip(*got_all):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# padding: the three scans on the reference's instances and draws
# ---------------------------------------------------------------------------

def _kway_case(use_kernel):
    rfn, rargs = rREG._build_kway(use_kernel)
    coo, labs, cap, rkeys, nr, z, f, a = rargs[:8]
    b, rounds, k = REG.KWAY_B, REG.KWAY_ROUNDS, REG.KWAY_K
    noise = np.stack([np.stack([np.asarray(jax.random.uniform(
        jnp.asarray(rk), (coo.n_pad, k), jnp.float32, 0.0, rlp._NOISE))
        for rk in row]) for row in rkeys[:b]])

    def port(args):
        out = [_port_coo(args[0]), T(args[1])[:b], T(args[2]), T(noise),
               T(args[4])[:b].long(), T(args[5])[:b], T(args[6])[:b],
               T(args[7])[:b]]
        if use_kernel:
            e = args[8]
            out.append(tcsr.EllGraph(T(e.nbr), T(e.wgt), T(e.vwgt)))
        return out

    def ref(args):
        return rfn(*args)
    name = "engine/kway_refine_kernel" if use_kernel else "engine/kway_refine"
    perturb = (rREG._perturb_kway_kernel if use_kernel
               else rREG._perturb_kway)
    return name, rargs, perturb, port, ref, rREG._project_kway


def _hyper_case(objective):
    from repro.core.hypergraph import refine as rHR
    rfn, rargs = rREG._build_hyper(objective)
    hc, labs, cap, keys, force = rargs
    k_pad = cap.shape[0]
    noise = np.stack([np.stack([np.asarray(jax.random.uniform(
        kr, (hc.n_pad, k_pad), jnp.float32, 0.0, rHR._NOISE))
        for kr in jax.random.split(jnp.asarray(key), REG.HYPER_ROUNDS)])
        for key in keys])
    base = tC.to_pincoo(REG._tiny_hypergraph(), device=CPU)

    def port(args):
        h = args[0]
        pc = tC.PinCoo(pv=T(h.pv), pe=T(h.pe), mask=T(h.mask),
                       netw=T(h.netw), esize=T(h.esize), vwgt=T(h.vwgt),
                       eptr=base.eptr)
        return [pc, T(args[1]), T(args[2]), T(noise), T(args[4])]

    def ref(args):
        with jax.disable_jit():       # op by op, as test_torch_kahypar.py
            return rfn(args[0], *(jnp.asarray(a) for a in args[1:]))
    return (f"engine/hyper_refine_{objective}", rargs, rREG._perturb_hyper,
            port, ref, rREG._project_hyper)


def _sep_case():
    from repro.core.nodesep import refine as rNR
    rfn, rargs = rREG._build_sep()
    coo, labs, cap, keys, force = rargs
    noise = np.stack([np.stack([np.asarray(jax.random.uniform(
        kr, (coo.n_pad,), jnp.float32, 0.0, rNR._NOISE))
        for kr in jax.random.split(jnp.asarray(key), REG.SEP_ROUNDS)])
        for key in keys])

    def port(args):
        return [_port_coo(args[0]), T(args[1]), T(args[2]), T(noise),
                T(args[4]), None]

    def ref(args):
        return rfn(*args)
    return ("engine/sep_refine", rargs, rREG._perturb_sep, port, ref,
            rREG._project_sep)


_SCANS = {"kway": lambda: _kway_case(False),
          "kway_kernel": lambda: _kway_case(True),
          "hyper_km1": lambda: _hyper_case("km1"),
          "hyper_cut": lambda: _hyper_case("cut"),
          "sep": _sep_case}


@pytest.mark.parametrize("case", sorted(_SCANS))
def test_scan_entry_bit_identical_on_reference_draws(case):
    """The port's scan entry on the reference's canonical instance and
    per-round draws equals the reference's run bit for bit, on the clean
    inputs and under the reference's perturbation; the port's padding
    check on those draws finds nothing."""
    name, rargs, perturb, port, ref, rproject = _SCANS[case]()
    entry = REG.default_registry()[name]
    fn, _ = entry.build(CPU)
    rows = REG.KWAY_B if case.startswith("kway") else None
    got_all = []
    for args in (rargs, perturb(rargs, np.random.default_rng(A11A))):
        want = rproject(ref(args))
        got = entry.padding.project(fn(*port(args)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w)[:rows])
        got_all.append(got)
    for a, b in zip(*got_all):
        np.testing.assert_array_equal(a, b)
    # the port's own perturbation (garbage in the draws' padding slots
    # too) on the reference's draws
    pargs = port(rargs)
    a = fn(*pargs)
    b = fn(*entry.padding.perturb(tuple(pargs),
                                  np.random.default_rng(A11A)))
    for x, y in zip(entry.padding.project(a), entry.padding.project(b)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# padding: every entry of the registry, and a planted fault
# ---------------------------------------------------------------------------

def test_every_padding_entry_inert_on_cpu():
    reg = REG.default_registry()
    names = [n for n, e in sorted(reg.items()) if "padding" in e.tags]
    assert len(names) == 17
    for name in names:
        assert padding.check_padding(reg[name], CPU) == [], name


def _broken_refine_entry():
    """The reference's `_broken_refine_entry` (tests/test_analysis.py), in
    torch: balance totals count *vertices* instead of vertex weight (so
    zero-weight padding rows enter them) and the overweight push lacks
    the ``vw > 0`` gate (so padding vertices are force-moved)."""
    g = REG._ring_graph()
    n = g.n

    def build(device, mesh=None):
        coo = tcsr.to_coo(g, device=device)
        labels0 = (torch.arange(coo.n_pad) % 2).to(torch.int32)

        def fn(coo, labels):
            k = 2
            for _ in range(3):
                # BUG: counts padding vertices into the balance totals
                sizes = torch.zeros(k).index_add_(
                    0, labels.long(), torch.ones(coo.n_pad))
                aff = torch.zeros(coo.n_pad * k).index_add_(
                    0, coo.src_long * k + labels[coo.dst_long].long(),
                    coo.w).view(coo.n_pad, k)
                own = aff.gather(1, labels.long()[:, None])[:, 0]
                gain = aff - own[:, None]
                gain.scatter_(1, labels.long()[:, None], -1e30)
                best = gain.argmax(1).to(labels.dtype)
                # BUG: force-move from the overweight block without vw > 0
                over = sizes[labels.long()] > sizes.sum() / k
                labels = torch.where(over, best, labels)
            sizes = torch.zeros(k).index_add_(0, labels.long(),
                                              torch.ones(coo.n_pad))
            return labels, sizes
        return fn, (coo, labels0)

    def perturb(args, rng):
        coo, labels = args
        return (REG._perturb_coo(coo, rng),
                REG._garble_rows(labels, n, 2, rng))

    return REG.EntryPoint(
        name="fixture/padding_force_move", build=build,
        tags=frozenset({"padding"}),
        padding=REG.PaddingSpec(perturb, lambda outs: [
            outs[0].numpy()[:n], outs[1].numpy()]))


def test_padding_flags_force_moved_padding_vertex():
    found = analyze_entry(_broken_refine_entry(), CPU)
    assert "padding-flows-into-output" in _codes(found)


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

def _entry(name, fn, args, **kw):
    return REG.EntryPoint(name=name, build=lambda device, mesh=None: (fn,
                                                                     args),
                          tags=frozenset({"hygiene"}), **kw)


def test_hygiene_flags_item_in_a_loop():
    def fn(x):
        total = 0.0
        for i in range(4):
            total += (x * i).sum().item()       # a sync per iteration
        return torch.tensor(total)

    found = analyze_entry(_entry("fixture/item_loop", fn,
                                 (torch.ones(3),)), CPU)
    assert _codes(found) == ["sync-in-loop"]
    assert found[0].detail["reads"] == 4
    one = analyze_entry(_entry("fixture/item_once", lambda x: int(x.sum()),
                               (torch.ones(3),)), CPU)
    assert _codes(one) == ["host-sync"]


def test_hygiene_flags_float64_op():
    found = analyze_entry(_entry(
        "fixture/f64", lambda x: (x.double() * 2).float(),
        (torch.ones(3),)), CPU)
    assert "wide-dtype" in _codes(found)


def test_hygiene_admits_the_allowed_gate_tap():
    """The tap's host copy is seen on the CPU too (a ``.cpu()`` read), and
    allowed only where the entry allows it."""
    reg = REG.default_registry()
    entry = reg["serve/moe_gate_tap"]
    traced = tracing.trace_entry(entry, CPU)
    sites = traced.sync_sites()
    assert sites.get("models/moe.py:_emit_gates", 0) > 0
    assert checkers.check_hygiene(traced, entry) == []
    bare = REG.EntryPoint(name=entry.name, build=entry.build,
                          tags=entry.tags)
    assert "sync-in-loop" in _codes(checkers.check_hygiene(traced, bare))
    # the decode without the tap reads nothing back
    assert tracing.trace_entry(reg["serve/decode_slots"],
                               CPU).sync_sites() == {}


def test_op_trace_records_ops_and_device_reads():
    with tracing.OpTrace() as t:
        x = torch.arange(6).reshape(2, 3)
        y = (x * 2).sum(1)
        y.tolist()
        y.cpu()
        bool(y[0] > 1)
    assert "aten.mul.Tensor" in t.ops and "aten.sum.dim_IntList" in t.ops
    assert [s.what for s in t.syncs] == ["tolist", "cpu", "__bool__"]


# ---------------------------------------------------------------------------
# lints
# ---------------------------------------------------------------------------

def test_host_sync_lint(tmp_path):
    """The reference's tmp file (tests/test_analysis.py) plus torch's
    forms."""
    bad = tmp_path / "glue.py"
    bad.write_text(
        "_HOST_SYNC_OK = (\"designed\",)\n"
        "def hot(xs):\n"
        "    total = 0\n"
        "    for x in xs:\n"
        "        total += x.item()\n"
        "        y = np.asarray(x)\n"
        "    return total\n"
        "def designed(x):\n"
        "    return int(np.asarray(x))\n"
        "def torchy(xs, n):\n"
        "    out = xs.cpu().numpy()\n"
        "    torch.cuda.synchronize()\n"
        "    for t in xs:\n"
        "        k = int(t.argmax())\n"
        "        ok = bool(t.any())\n"
        "        m = int(len(xs) + 1)\n"
        "    return xs.tolist()\n")
    found = lint.check_host_sync(serve_dir=str(tmp_path))
    codes = _codes(found)
    for c in ("sync-item", "materialize-in-loop", "sync-cpu", "sync-numpy",
              "sync-synchronize", "sync-tolist"):
        assert c in codes, c
    lines = sorted(int(f.location.rsplit(":", 1)[1]) for f in found)
    assert lines == [5, 6, 11, 11, 12, 14, 15, 17]
    # the allowlisted designed sync point (line 9) is not flagged


def test_serve_tree_passes_host_sync_lint():
    assert lint.check_host_sync() == []


def test_batching_declares_its_sync_points():
    import ast
    from repro_torch.serve import batching
    tree = ast.parse(Path(batching.__file__).read_text())
    assert lint._marker_names(tree) == ("add", "step")


def test_driver_registry_lint_clean_and_complete():
    assert lint.check_driver_registry() == []
    reg = REG.default_registry()
    for entries in REG.DRIVER_ENTRIES.values():
        for name in entries:
            assert name in reg
    # the same drivers as the reference's registry, and the same entries
    # for each, plus the port's own
    assert set(REG.DRIVER_ENTRIES) == set(rREG.DRIVER_ENTRIES)
    for k, v in rREG.DRIVER_ENTRIES.items():
        assert set(v) <= set(REG.DRIVER_ENTRIES[k]), k
    assert set(rREG.default_registry()) <= set(reg)


def test_driver_registry_lint_flags_unregistered_driver():
    incomplete = {k: v for k, v in REG.DRIVER_ENTRIES.items()
                  if k != "kaffpa"}
    found = lint.check_driver_registry(driver_entries=incomplete)
    assert any(f.code == "driver-unregistered" and f.entry == "kaffpa"
               for f in found)
    dangling = dict(REG.DRIVER_ENTRIES, kaffpa=("engine/none",))
    assert _codes(lint.check_driver_registry(driver_entries=dangling)) \
        == ["driver-dangling-entry"]


# ---------------------------------------------------------------------------
# the whole tree, the CLI, the spmd check on 4 ranks
# ---------------------------------------------------------------------------

def test_analyze_counts_findings_in_obs():
    before = obs.metrics.get("analysis/violations")
    reg = {"fixture/f64": _entry("fixture/f64",
                                 lambda x: (x.double() * 2).float(),
                                 (torch.ones(3),))}
    found = analyze(entries=["fixture/f64"], registry=reg, lints=False,
                    device=CPU)
    assert found and obs.metrics.get("analysis/violations") > before
    assert obs.metrics.get("analysis/hygiene") >= 1


def test_cli_clean_tree_exits_zero(tmp_path):
    out = tmp_path / "findings.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--device", "cpu", "--no-exercise", "--out",
                        str(out)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 findings" in r.stdout
    headers, events = obs.read_jsonl(str(out))
    assert headers[0]["name"] == "analysis" and events == []
    listed = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                             "--list"], capture_output=True, text=True,
                            timeout=120, env=env)
    assert listed.returncode == 0
    assert len(listed.stdout.splitlines()) == len(REG.default_registry())


def test_cli_default_device_is_the_card():
    from repro_torch.analysis.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError):
        main(["--no-exercise", "--entries", "kernels/lp_affinity"])


@pytest.mark.parametrize("call", [
    lambda: analyze(entries=["kernels/lp_affinity"], lints=False),
    lambda: analyze_entry(REG.default_registry()["kernels/lp_affinity"]),
    lambda: exercise_drivers(),
], ids=["analyze", "analyze_entry", "exercise_drivers"])
def test_library_default_device_is_the_card(call):
    """A library caller that names no device checks the card, never the
    plain CPU paths: without one it raises before running anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_spmd_on_four_ranks():
    """Zero findings on parhip, the parhyp rounds (``nets`` and the 2-D
    ``(nets, verts)`` mesh), the clustering and contraction, the ring; a
    Φ that skips its psum over ``nets`` is flagged, naming the axis; every
    rank returns the same findings."""
    _SPMD["thread"].join()
    if "error" in _SPMD:
        raise _SPMD["error"]
    ranks = _SPMD["out"]
    out = ranks[0]
    for name in torch_ranks.SPMD_ENTRIES + ("fixture/phi_True",):
        assert out[f"spmd/{name}"].size == 0, (name, out[f"spmd/{name}"])
    assert out["spmd/fixture/phi_False"].tolist() == [
        "varying-as-replicated"]
    assert out["axes/fixture/phi_False"].tolist() == ["nets"]
    for r in ranks[1:]:
        for key in out:
            np.testing.assert_array_equal(r[key], out[key])


def test_spmd_digest_and_axes():
    from repro_torch.analysis import spmd
    assert spmd.digest(torch.ones(3)) == spmd.digest(np.ones(3, np.float32))
    assert spmd.digest(torch.ones(3)) != spmd.digest(torch.ones(4))
    h = np.array([1, 1, 2, 2])              # (2, 2): differs along axis 0
    assert spmd.varying_axes(h, (2, 2), ("nets", "verts")) == ["nets"]
    assert spmd.varying_axes(np.array([1, 2, 1, 2]), (2, 2),
                             ("nets", "verts")) == ["verts"]
