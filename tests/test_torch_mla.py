"""Port parity for Multi-head Latent Attention (deepseek-v2 at the
reduced config: MLA + MoE): the forward on the reference's weights, the
weight-absorbed one-token decode against the reference's decode and the
port's own forward at capacity factor 8.0 (nothing drops, so the two
differ only by float rounding, as
tests/test_models.py::test_moe_mismatch_is_capacity_drops_only holds the
reference), per-row cursors, and the compressed cache."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as r_get_config
from repro.models import mla as rMLA
from repro.models import transformer as rT

from repro_torch.configs.base import get_config
from repro_torch.models import mla as tMLA
from repro_torch.models import transformer as tT
from repro_torch.models.weights import params_from_jax

ARCH = "deepseek_v2_236b"
# capacity factor 8.0: no token drops in decode or in the forward
CFG = dataclasses.replace(get_config(ARCH).reduced(), capacity_factor=8.0)
RCFG = dataclasses.replace(r_get_config(ARCH).reduced(),
                           capacity_factor=8.0)
B, S = 2, 8


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def weights():
    jp = rT.init_params(RCFG, jax.random.PRNGKey(1))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG,
                               device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(5).integers(0, CFG.vocab, (B, S)) \
        .astype(np.int32)


def _decode(step, caches, tokens):
    outs = []
    for t in range(tokens.shape[1]):
        lg, caches = step(tokens[:, t:t + 1], caches, t)
        outs.append(np.asarray(lg)[:, 0])
    return np.stack(outs, 1)


def test_forward_matches_reference(weights, tokens):
    jp, model = weights
    want, _ = rT.forward(jp, RCFG, jnp.asarray(tokens))
    got, _ = tT.forward(model, CFG, torch.from_numpy(tokens))
    assert got.shape == (B, S, CFG.vocab_pad)
    assert _rel(got, want) < 1e-4
    names = model.state_dict()
    for leaf in ("attn.wdq", "attn.q_gamma", "attn.wuk", "attn.wkr",
                 "moe.router", "moe.ws_down"):
        assert f"blocks.1.{leaf}" in names
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_absorbed_decode_matches_reference_decode(weights, tokens):
    """Token by token (s == 1 with a cache: the absorbed path) against the
    reference's decode, and against the port's own forward, both within
    1e-4 absolute, the reference test's bound."""
    jp, model = weights
    want = _decode(lambda tok, c, t: rT.forward(
        jp, RCFG, jnp.asarray(tok), caches=c, cache_pos=t),
        rT.init_caches(RCFG, B, S), tokens)
    caches = tT.init_caches(CFG, B, S, device="cpu")
    got = _decode(lambda tok, c, t: tT.forward(
        model, CFG, torch.from_numpy(tok), caches=c, cache_pos=t),
        caches, tokens)
    assert float(np.abs(got - want).max()) < 1e-4
    full, _ = tT.forward(model, CFG, torch.from_numpy(tokens))
    assert float(np.abs(got - full.numpy()).max()) < 1e-4
    assert set(caches) == {"ckv", "kr"}
    assert caches["ckv"].shape == (CFG.n_layers, B, S, CFG.kv_lora)
    assert caches["kr"].shape == (CFG.n_layers, B, S, CFG.rope_head_dim)


class _Shapes(torch.overrides.TorchFunctionMode):
    """Records the shape of every tensor a torch function returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def test_absorbed_step_never_builds_the_up_projection(weights):
    """The one-token step with a cache builds no (Smax, h·dn) key and no
    (Smax, h·dv) value from the cache (the explicit path of a two-token
    step does), and equals the explicit path's second position."""
    _, model = weights
    p = model.blocks[0].attn
    h, dn, dv = CFG.n_heads, CFG.nope_head_dim, CFG.v_head_dim
    smax = 12
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, 2, CFG.d_model)).astype(np.float32))
    positions = torch.tensor([[0, 1]]).expand(B, 2)

    def cache():
        return {"ckv": torch.zeros(B, smax, CFG.kv_lora),
                "kr": torch.zeros(B, smax, CFG.rope_head_dim)}

    up = {(B, smax, h * dn), (B, smax, h * dv)}
    with _Shapes() as explicit:
        both, _ = tMLA.mla_attention(p, x, CFG, positions, cache=cache(),
                                     cache_pos=0)
    assert up <= set(explicit.shapes)
    c = cache()
    tMLA.mla_attention(p, x[:, :1], CFG, positions[:, :1], cache=c,
                       cache_pos=0)
    with _Shapes() as absorbed:
        step, _ = tMLA.mla_attention(p, x[:, 1:], CFG, positions[:, 1:],
                                     cache=c, cache_pos=1)
    assert not up & set(absorbed.shapes)
    assert _rel(step[:, 0], both[:, 1]) < 1e-5


def test_per_row_cursors_equal_rows_run_alone(weights, tokens):
    """A (B,) cursor tensor through MLA (and per-row MoE dispatch): each
    row decodes at its own position exactly as it does alone."""
    _, model = weights

    def step(tok, caches, pos):
        return tT.forward(model, CFG, torch.from_numpy(tok), caches=caches,
                          cache_pos=pos)[0][:, 0]

    caches = tT.init_caches(CFG, B, S, device="cpu")
    solo = [tT.init_caches(CFG, 1, S, device="cpu") for _ in range(B)]
    row1 = {k: v[:, 1:2] for k, v in caches.items()}
    for t in range(3):              # row 1 runs three tokens ahead
        step(tokens[1:2, t:t + 1], row1, t)
        step(tokens[1:2, t:t + 1], solo[1], t)
    for t in range(S - 3):
        pos = np.array([t, t + 3])
        tok = tokens[np.arange(B), pos][:, None]
        got = step(tok, caches, torch.from_numpy(pos))
        for r in range(B):
            want = step(tok[r:r + 1], solo[r], int(pos[r]))
            assert _rel(got[r], want[0]) < 1e-5


def test_mla_layer_matches_reference(weights):
    """One MLA layer, no cache and with a cache at an offset, on the
    reference's weights."""
    jp, model = weights
    p0 = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    x = np.random.default_rng(4).standard_normal((B, 6, CFG.d_model)) \
        .astype(np.float32)
    pos = np.arange(6)
    want, _ = rMLA.mla_attention(p0, jnp.asarray(x), RCFG, jnp.asarray(pos))
    got, _ = tMLA.mla_attention(model.blocks[0].attn, torch.from_numpy(x),
                                CFG, torch.from_numpy(pos)[None].expand(B, 6))
    assert _rel(got, want) < 1e-5
    rc = {"ckv": jnp.zeros((B, 10, CFG.kv_lora)),
          "kr": jnp.zeros((B, 10, CFG.rope_head_dim))}
    tc = {"ckv": torch.zeros(B, 10, CFG.kv_lora),
          "kr": torch.zeros(B, 10, CFG.rope_head_dim)}
    want, rc = rMLA.mla_attention(p0, jnp.asarray(x), RCFG,
                                  jnp.asarray(pos + 3), cache=rc,
                                  cache_pos=3)
    got, tc = tMLA.mla_attention(model.blocks[0].attn, torch.from_numpy(x),
                                 CFG, torch.from_numpy(pos + 3)[None]
                                 .expand(B, 6), cache=tc, cache_pos=3)
    assert _rel(got, want) < 1e-5
    for name in ("ckv", "kr"):
        assert _rel(tc[name], rc[name]) < 1e-6
