"""Port parity for the hybrid (zamba2) model stack at the reduced config:
the Mamba2 mixer per engine, the full-sequence forward and token-by-token
decode against the JAX package on the same weights (``params_from_jax``),
the port's decode against its own forward, online against dense
attention, and the port's refusals."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as r_get_config
from repro.models import attention as rA
from repro.models import mamba2 as rM2
from repro.models import transformer as rT

from repro_torch.configs.base import get_config
from repro_torch.models import attention as tA
from repro_torch.models import mamba2 as tM2
from repro_torch.models import transformer as tT
from repro_torch.models.weights import params_from_jax

CFG = get_config("zamba2_2p7b").reduced()
RCFG = r_get_config("zamba2_2p7b").reduced()
B, S = 2, 10


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def weights():
    """The reference's own init (PRNGKey 1), and the port holding it."""
    jp = rT.init_params(RCFG, jax.random.PRNGKey(1))
    model = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return jp, model


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(5).integers(0, CFG.vocab, (B, S)) \
        .astype(np.int32)


def test_config_copy_matches_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(RCFG)
    full = get_config("zamba2_2p7b")
    assert (full.n_layers, full.d_model, full.vocab_pad, full.ssm_nheads,
            full.attn_every) == (54, 2560, 32256, 80, 6)


def test_params_from_jax_maps_every_leaf(weights):
    jp, model = weights
    assert len(model.blocks) == CFG.n_layers
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    np.testing.assert_array_equal(
        model.blocks[3].mamba.in_proj.numpy(),
        np.asarray(jp["blocks"]["mamba"]["in_proj"][3]))
    np.testing.assert_array_equal(model.shared.attn.wq.numpy(),
                                  np.asarray(jp["shared"]["attn"]["wq"]))
    assert "blocks.3.mamba.in_proj" in model.state_dict()
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("engine,ref_engine", [
    ("chunked", "chunked"), ("kernel", "pallas"), ("ref", "ref")])
def test_mixer_matches_reference(weights, engine, ref_engine):
    jp, model = weights
    x = np.random.default_rng(2).standard_normal(
        (B, 70, CFG.d_model)).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[1], jp["blocks"]["mamba"])
    want, _ = rM2.mamba2_mixer(p0, jnp.asarray(x), RCFG, engine=ref_engine)
    got, st = tM2.mamba2_mixer(model.blocks[1].mamba, torch.from_numpy(x),
                               CFG, engine=engine)
    assert st is None and got.shape == (B, 70, CFG.d_model)
    assert _rel(got, want) < 1e-4


def test_mixer_module_default_engine_is_chunked_on_cpu(weights):
    _, model = weights
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 12, CFG.d_model)).astype(np.float32))
    mixer = model.blocks[0].mamba
    got, _ = mixer(x)
    want, _ = tM2.mamba2_mixer(mixer, x, CFG, engine="chunked")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="engine"):
        mixer(x, engine="pallas")


def test_forward_matches_reference(weights, tokens):
    jp, model = weights
    want, _ = rT.forward(jp, RCFG, jnp.asarray(tokens))
    got, caches = tT.forward(model, CFG, torch.from_numpy(tokens))
    assert caches is None
    assert got.shape == (B, S, CFG.vocab_pad) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-4
    # the kernel engine (the exact recurrence on the CPU) and the module
    # call give the same function
    got_k, _ = model(torch.from_numpy(tokens), engine="kernel")
    assert _rel(got_k, want) < 1e-4


def _decode(step, caches, tokens):
    outs = []
    for t in range(tokens.shape[1]):
        lg, caches = step(tokens[:, t:t + 1], caches, t)
        outs.append(np.asarray(lg)[:, 0])
    return np.stack(outs, 1)


def test_decode_matches_reference_decode(weights, tokens):
    jp, model = weights
    want = _decode(lambda tok, c, t: rT.forward(
        jp, RCFG, jnp.asarray(tok), caches=c, cache_pos=t),
        rT.init_caches(RCFG, B, S), tokens)
    got = _decode(lambda tok, c, t: tT.forward(
        model, CFG, torch.from_numpy(tok), caches=c, cache_pos=t),
        tT.init_caches(CFG, B, S, device="cpu"), tokens)
    assert _rel(got, want) < 1e-4


def test_decode_matches_full_forward(weights, tokens):
    """As tests/test_models.py::test_decode_matches_full_forward holds the
    reference: token by token equals the full forward within 2e-3."""
    _, model = weights
    full, _ = tT.forward(model, CFG, torch.from_numpy(tokens))
    caches = tT.init_caches(CFG, B, S, device="cpu")
    inc = _decode(lambda tok, c, t: tT.forward(
        model, CFG, torch.from_numpy(tok), caches=c, cache_pos=t),
        caches, tokens)
    assert _rel(inc, full.numpy()) < 2e-3
    assert caches["ssm"].abs().max() > 0       # written in place


def test_per_row_cursors_equal_rows_run_alone(weights, tokens):
    """A (B,) cursor tensor: each row decodes at its own position exactly
    as it does alone (the batch dimension that replaces the reference's
    vmap over slots)."""
    _, model = weights

    def step(tok, caches, pos):
        return tT.forward(model, CFG, torch.from_numpy(tok), caches=caches,
                          cache_pos=pos)[0][:, 0]

    caches = tT.init_caches(CFG, B, S, device="cpu")
    solo = [tT.init_caches(CFG, 1, S, device="cpu") for _ in range(B)]
    row1 = {"attn": {k: v[:, 1:2] for k, v in caches["attn"].items()},
            "ssm": caches["ssm"][:, 1:2], "conv": caches["conv"][:, 1:2]}
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


def test_online_attention_matches_dense():
    rng = np.random.default_rng(1)
    b, sq, h, hd, kvh = 2, 96, 4, 16, 2
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, sq, h, hd), (b, sq, kvh, hd), (b, sq, kvh, hd)))
    dense = tA._sdpa(q, k, v, torch.ones(sq, sq, dtype=torch.bool).tril(),
                     None, 0.25)
    online = tA._sdpa_online(q, k, v, None, 0.25, q_offset=0)
    torch.testing.assert_close(online, dense, rtol=2e-4, atol=2e-4)
    # per-row offsets, and the reference's dense version
    off = torch.tensor([0, 5])
    kidx = torch.arange(sq)[None, None, :]
    mask = kidx <= off[:, None, None] + torch.arange(sq)[:, None]
    dense_rows = tA._sdpa(q, k, v, mask, None, 0.25)
    online_rows = tA._sdpa_online(q, k, v, None, 0.25, q_offset=off)
    torch.testing.assert_close(online_rows, dense_rows, rtol=2e-4,
                               atol=2e-4)
    ref = rA._sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                   jnp.tril(jnp.ones((sq, sq), bool)), None, 0.25)
    assert _rel(dense, ref) < 1e-5


def test_causal_mask_matches_reference():
    from repro.models.layers import causal_mask as r_mask
    from repro_torch.models.layers import causal_mask
    for q_len, kv, off in ((4, 4, 0), (3, 9, 5), (1, 16, 15)):
        assert np.array_equal(causal_mask(q_len, kv, off).numpy(),
                              np.asarray(r_mask(q_len, kv, q_offset=off)))
    rows = causal_mask(3, 9, torch.tensor([0, 5]))
    assert rows.shape == (2, 3, 9)
    assert torch.equal(rows[0], causal_mask(3, 9, 0))
    assert torch.equal(rows[1], causal_mask(3, 9, 5))


def test_mixer_raises_on_multi_token_state(weights):
    _, model = weights
    st = tM2.init_mamba2_state(CFG, 1)
    x = torch.zeros(1, 3, CFG.d_model)
    with pytest.raises(ValueError, match="one step"):
        tM2.mamba2_mixer(model.blocks[0].mamba, x, CFG, state=st)


def test_prefill_step_runs_a_long_prompt_token_by_token(weights):
    """A 12-token prompt through `prefill_step` ends at the full
    forward's last-position logits (the reference's hybrid prefill, which
    reads step 0 only, misses them by ~1.5e-3 of max)."""
    _, model = weights
    from repro_torch.serve.serve_step import prefill_step
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(1, CFG.vocab, (2, 12)))
    caches = tT.init_caches(CFG, 2, 16, device="cpu")
    last, caches = prefill_step(model, CFG, tokens, caches)
    full, _ = tT.forward(model, CFG, tokens)
    assert _rel(last, full[:, -1]) < 1e-5
    # the caches hold the prompt: the next decode step continues it
    nxt = full[:, -1].argmax(-1)[:, None]
    step, _ = tT.forward(model, CFG, nxt, caches=caches, cache_pos=12)
    want, _ = tT.forward(model, CFG, torch.cat([tokens, nxt], 1))
    assert _rel(step[:, -1], want[:, -1]) < 2e-3


def test_init_params_without_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tT.init_params(CFG, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tT.init_caches(CFG, 1, 8)
    model = tT.init_params(CFG, 0, device="cpu")
    again = tT.init_params(CFG, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))
    logits, _ = model(torch.zeros(1, 4, dtype=torch.long))
    assert logits.shape == (1, 4, CFG.vocab_pad)
    assert torch.isfinite(logits).all()

