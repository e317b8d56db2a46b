"""Port parity for the MoE family at the reduced config (llama4-scout:
top-1 + shared; deepseek-v2: MLA + top-2 + shared after `reduced()`):
`moe_ffn` on the reference's weights, at a capacity that drops tokens
and at one dispatch group of 4096 tokens (the capacity's round-up to
512); the per-row dispatch of a batched decode, which the reference
gets by decoding each slot alone; the gate tap; the co-activation graph;
expert placement by the port's kaffpa; the llama4 forward and decode
against the JAX package."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as r_get_config
from repro.models import moe as rM
from repro.models import transformer as rT
from repro.serve import batching as rB

from repro_torch.configs.base import get_config
from repro_torch.models import moe as tM
from repro_torch.models import transformer as tT
from repro_torch.models.layers import ParamTree
from repro_torch.models.weights import params_from_jax

ARCH = "llama4_scout_17b_a16e"
CFG = get_config(ARCH).reduced()
RCFG = r_get_config(ARCH).reduced()
TOL = 1e-5          # of max |y|: one MoE layer, port against the reference


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _moe_params(arch, seed=0):
    """The reference's `init_moe` and the port's ParamTree holding it."""
    rcfg = r_get_config(arch).reduced()
    jp = rM.init_moe(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    return jp, ParamTree({k: torch.from_numpy(np.array(v))
                          for k, v in jp.items()})


def _x(shape, seed=2, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _dropped(gate_idx, cap, n_experts):
    """Tokens with a dropped pair: beyond the first ``cap`` pairs of their
    expert in token order (the stable sort's order)."""
    seen = np.zeros(n_experts, np.int64)
    out = set()
    for t, row in enumerate(gate_idx):
        for e in row:
            seen[e] += 1
            if seen[e] > cap:
                out.add(t)
    return out


@pytest.fixture(scope="module")
def llama4():
    jp = rT.init_params(RCFG, jax.random.PRNGKey(1))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG,
                               device="cpu")


@pytest.mark.parametrize("arch", [ARCH, "deepseek_v2_236b"])
def test_moe_ffn_drops_the_reference_tokens(arch):
    """At capacity factor 0.5 some (token, expert) pairs overflow: the
    port's output equals the reference's, token by token, so the same
    tokens were dropped; at 8.0 nothing drops and the dropped tokens'
    outputs change."""
    jp, tp = _moe_params(arch)
    x = _x((2, 24, CFG.d_model))
    outs = {}
    for cf in (0.5, 8.0):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  capacity_factor=cf)
        rcfg = dataclasses.replace(r_get_config(arch).reduced(),
                                   capacity_factor=cf)
        want = np.asarray(rM.moe_ffn(jp, jnp.asarray(x), rcfg))
        got = tM.moe_ffn(tp, torch.from_numpy(x), cfg).numpy()
        assert _rel(got, want) < TOL, cf
        outs[cf] = got.reshape(-1, cfg.d_model)
    cfg = get_config(arch).reduced()
    gates = []
    with tM.observe_gates(gates.append):
        tM.moe_ffn(tp, torch.from_numpy(x), cfg)
    cap = tM.capacity(48, dataclasses.replace(cfg, capacity_factor=0.5))
    dropped = _dropped(gates[0], cap, cfg.n_experts)
    assert dropped                              # the factor bites
    diff = np.abs(outs[0.5] - outs[8.0]).max(1)
    changed = set(np.flatnonzero(diff > 1e-4 * np.abs(outs[8.0]).max()))
    assert changed == dropped


def test_capacity_rule():
    cfg = dataclasses.replace(CFG, capacity_factor=0.3)
    assert tM.capacity(1, CFG) == 1
    assert tM.capacity(8, CFG) == 2                 # ceil(8·1·1.25/8)
    assert tM.capacity(4095, cfg) == 154            # ceil(4095·0.3/8)
    assert tM.capacity(4096, cfg) == 512            # 154 → rounded to 512


def test_moe_ffn_matches_reference_at_4096_tokens():
    """One dispatch group of 4096 tokens: the capacity rounds up to 512,
    which decides which pairs drop at capacity factor 0.3."""
    arch = "deepseek_v2_236b"
    jp, tp = _moe_params(arch, seed=3)
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              capacity_factor=0.3)
    rcfg = dataclasses.replace(r_get_config(arch).reduced(),
                               capacity_factor=0.3)
    x = _x((1, 4096, cfg.d_model), seed=4)
    want = np.asarray(rM.moe_ffn(jp, jnp.asarray(x), rcfg))
    got = tM.moe_ffn(tp, torch.from_numpy(x), cfg).numpy()
    assert _rel(got, want) < TOL


def test_per_row_dispatch_equals_rows_alone():
    """Pitfall of one batched decode call: B rows of one token each.  As
    one group of B tokens (capacity max(1, ⌈B·k·1.25/E⌉) = 1 here) two
    rows routed to one expert drop one of them; per row, each row has
    its own capacity, exactly as the reference's per-slot decode has."""
    jp, tp = _moe_params(ARCH, seed=1)
    x = _x((6, 1, CFG.d_model), seed=9)
    gates = []
    with tM.observe_gates(gates.append):
        rows = tM.moe_ffn(tp, torch.from_numpy(x), CFG, per_row=True)
        one_group = tM.moe_ffn(tp, torch.from_numpy(x), CFG)
    per_row_gates, group_gates = gates
    assert per_row_gates.shape == (6, CFG.top_k)
    np.testing.assert_array_equal(per_row_gates, group_gates)
    assert len(set(group_gates[:, 0])) < 6        # two rows share an expert
    for r in range(6):
        alone = np.asarray(rM.moe_ffn(jp, jnp.asarray(x[r:r + 1]), RCFG))
        assert _rel(rows[r:r + 1], alone) < TOL
    assert _rel(one_group, rows) > 1e-2           # the group dropped rows


def test_batched_decode_equals_jax_per_slot_decode(llama4):
    """The port's batched decode (per-row cursors, per-row dispatch) gives
    the JAX batcher's vmapped per-slot decode (`_decode_slots`) on the
    same caches, row by row, and the one-slot decode of each row."""
    jp, model = llama4
    b, smax = 4, 16
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, CFG.vocab, n) for n in (5, 3, 7, 4)]
    caches = tT.init_caches(CFG, b, smax, device="cpu")
    rcaches = rT.init_caches(RCFG, b, smax)
    solo = []
    for r, p in enumerate(prompts):      # prefill each slot token by token
        view = {k: v[:, r:r + 1] for k, v in caches.items()}
        one = tT.init_caches(CFG, 1, smax, device="cpu")
        rview = jax.tree.map(lambda c: c[:, r:r + 1], rcaches)
        for t, tok in enumerate(p):
            tok = torch.tensor([[int(tok)]])
            tT.forward(model, CFG, tok, caches=view, cache_pos=t)
            tT.forward(model, CFG, tok, caches=one, cache_pos=t)
            _, rview = rB._step1(jp, RCFG, jnp.asarray(tok.numpy()), rview,
                                 jnp.int32(t))
        rcaches = jax.tree.map(lambda full, piece: full.at[:, r:r + 1]
                               .set(piece), rcaches, rview)
        solo.append(one)
    pos = np.array([len(p) for p in prompts])
    last = rng.integers(1, CFG.vocab, b)
    for step in range(3):
        got, _ = tT.forward(model, CFG, torch.from_numpy(last[:, None]),
                            caches=caches, cache_pos=torch.from_numpy(pos))
        want, rcaches = rB._decode_slots(jp, RCFG, jnp.asarray(last),
                                         jnp.asarray(pos, jnp.int32),
                                         rcaches)
        assert _rel(got[:, 0], want) < 1e-4, step
        for r in range(b):
            alone, _ = tT.forward(model, CFG, torch.tensor([[int(last[r])]]),
                                  caches=solo[r], cache_pos=int(pos[r]))
            assert _rel(got[r, 0], alone[0, 0]) < 1e-5, (step, r)
        last = got[:, 0].argmax(-1).numpy()
        pos = pos + 1


def test_forward_and_decode_match_reference(llama4):
    jp, model = llama4
    tokens = np.random.default_rng(5).integers(0, CFG.vocab, (2, 10)) \
        .astype(np.int32)
    want, _ = rT.forward(jp, RCFG, jnp.asarray(tokens))
    got, _ = tT.forward(model, CFG, torch.from_numpy(tokens))
    assert _rel(got, want) < 1e-4
    assert "blocks.1.moe.w_gate" in model.state_dict()
    assert model.blocks[1].moe.w_gate.shape == (CFG.n_experts, CFG.d_model,
                                                CFG.d_ff_expert)
    assert "lm_head" in model.state_dict()
    rc, tc = rT.init_caches(RCFG, 2, 10), tT.init_caches(CFG, 2, 10,
                                                         device="cpu")
    for t in range(10):
        tok = tokens[:, t:t + 1]
        w, rc = rT.forward(jp, RCFG, jnp.asarray(tok), caches=rc,
                           cache_pos=t)
        g, _ = tT.forward(model, CFG, torch.from_numpy(tok), caches=tc,
                          cache_pos=t)
        assert _rel(g, w) < 1e-4, t


def test_observe_gates_reports_every_layer(llama4):
    """One (T, k) host array per MoE layer, equal to the reference's tap;
    an object with ``observe`` works as a sink; nothing is reported
    outside the context."""
    jp, model = llama4
    tokens = np.random.default_rng(6).integers(0, CFG.vocab, (2, 7))
    got, want = [], []

    class Sink:
        def observe(self, idx):
            got.append(idx)

    with tM.observe_gates(Sink()):
        tT.forward(model, CFG, torch.from_numpy(tokens))
    with rM.observe_gates(want.append):
        rT.forward(jp, RCFG, jnp.asarray(tokens))
    assert len(got) == len(want) == CFG.n_layers
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == (14, CFG.top_k)
        np.testing.assert_array_equal(g, np.asarray(w).reshape(g.shape))
    after = []
    tM.observe_gates(after.append)      # a context never entered
    tT.forward(model, CFG, torch.from_numpy(tokens))
    assert after == [] and tM._gate_observer is None


def test_coactivation_graph_matches_reference():
    gate_idx = np.random.default_rng(0).integers(0, 8, (300, 3))
    gate_idx[:, 1] = (gate_idx[:, 0] + 1 + gate_idx[:, 1] % 7) % 8
    got = tM.coactivation_graph(gate_idx, 8)
    want = rM.coactivation_graph(gate_idx, 8)
    for name in ("xadj", "adjncy", "vwgt", "adjwgt"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    load = np.arange(8)
    np.testing.assert_array_equal(
        tM.coactivation_graph(gate_idx, 8, load).vwgt,
        np.asarray(rM.coactivation_graph(gate_idx, 8, load).vwgt))


@pytest.mark.parametrize("k", [2, 1])
def test_expert_placement_roundtrip(k):
    """As tests/test_models.py::test_moe_expert_placement_roundtrip: the
    placement is a permutation in equal shards, and the placed stacks
    give the unplaced output (1e-4).  k = 1 (llama4-scout's top-1) makes
    a graph with no edge: kaffpa balances the load alone."""
    gate_idx = np.random.default_rng(0).integers(0, CFG.n_experts, (500, k))
    perm = tM.expert_placement(gate_idx, CFG.n_experts, 4, seed=1,
                               device="cpu")
    assert sorted(perm.tolist()) == list(range(CFG.n_experts))
    _, tp = _moe_params(ARCH)
    placed = tM.place_experts(tp, perm)
    assert torch.equal(placed.w_up[0], tp.w_up[int(perm[0])])
    assert torch.equal(placed.router[:, 0], tp.router[:, int(perm[0])])
    x = torch.from_numpy(_x((1, 8, CFG.d_model), scale=0.1))
    np.testing.assert_allclose(tM.moe_ffn(placed, x, CFG).numpy(),
                               tM.moe_ffn(tp, x, CFG).numpy(),
                               rtol=1e-4, atol=1e-5)
    if not torch.cuda.is_available():           # device=None means CUDA
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tM.expert_placement(gate_idx, CFG.n_experts, 4, seed=1)
