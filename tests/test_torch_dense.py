"""Port parity for the dense and vlm decoder families at the reduced
config (minicpm, gemma2, starcoder2, mistral-large, internvl2 with its
prefix embeddings): the full-sequence forward and token-by-token decode
against the JAX package on the reference's own weights
(``params_from_jax``), the port's decode against its own forward,
gemma2's sliding window past its reduced width, online against dense
attention with a window, `prefill_step` then `decode_step`, per-row
cursors, and the device rule for every ported family."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as r_get_config
from repro.models import attention as rA
from repro.models import transformer as rT
from repro.models.layers import causal_mask as r_causal_mask
from repro.serve import serve_step as rS

from repro_torch.configs.base import get_config
from repro_torch.models import attention as tA
from repro_torch.models import transformer as tT
from repro_torch.models.layers import causal_mask
from repro_torch.models.weights import params_from_jax
from repro_torch.serve import serve_step as tS

DENSE = ["minicpm_2b", "gemma2_9b", "starcoder2_15b", "mistral_large_123b",
         "internvl2_26b"]
PORTED = DENSE + ["llama4_scout_17b_a16e", "deepseek_v2_236b",
                  "zamba2_2p7b", "rwkv6_7b", "whisper_medium"]
B = 2
# forward length per arch: gemma2 runs past its reduced window of 32
SEQ = {"gemma2_9b": 40}
TOL = 1e-4          # of max |logits|: port against the JAX package


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cfgs(arch):
    return get_config(arch).reduced(), r_get_config(arch).reduced()


_MODELS = {}


def _weights(arch):
    """The reference's own init (PRNGKey 1) and the port holding it,
    made once per arch."""
    if arch not in _MODELS:
        cfg, rcfg = _cfgs(arch)
        jp = rT.init_params(rcfg, jax.random.PRNGKey(1))
        _MODELS[arch] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                             cfg, device="cpu"))
    return _MODELS[arch]


def _tokens(cfg, s, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, s)) \
        .astype(np.int32)


def _prefix(cfg):
    """Stub patch embeddings for the vlm family, else None."""
    if not cfg.n_prefix_embeds:
        return None
    return (np.random.default_rng(6).standard_normal(
        (B, cfg.n_prefix_embeds, cfg.d_model)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("arch", PORTED)
def test_config_copy_matches_reference(arch):
    cfg, rcfg = _cfgs(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(r_get_config(arch))


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_jax_maps_every_leaf(arch):
    cfg, _ = _cfgs(arch)
    jp, model = _weights(arch)
    assert type(model) is tT.DecoderLM and len(model.blocks) == cfg.n_layers
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    np.testing.assert_array_equal(model.blocks[1].attn.wq.numpy(),
                                  np.asarray(jp["blocks"]["attn"]["wq"][1]))
    names = model.state_dict()
    assert "blocks.1.attn.wq" in names and "blocks.1.mlp.w_up" in names
    assert ("lm_head" in names) == (not cfg.tie_embeddings)
    assert ("blocks.0.post1" in names) == cfg.local_global_alternate
    assert ("blocks.0.mlp.w_gate" in names) == (not cfg.mlp_gelu)
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    cfg, rcfg = _cfgs(arch)
    jp, model = _weights(arch)
    s = SEQ.get(arch, 10)
    tokens, prefix = _tokens(cfg, s), _prefix(cfg)
    rkw = {} if prefix is None else {"prefix_embeds": jnp.asarray(prefix)}
    tkw = {} if prefix is None else {"prefix_embeds":
                                     torch.from_numpy(prefix)}
    want, _ = rT.forward(jp, rcfg, jnp.asarray(tokens), **rkw)
    got, caches = tT.forward(model, cfg, torch.from_numpy(tokens), **tkw)
    assert caches is None and got.dtype == torch.float32
    assert got.shape == (B, s + cfg.n_prefix_embeds, cfg.vocab_pad)
    assert _rel(got, want) < TOL
    # the module call is the same function
    got_m, _ = model(torch.from_numpy(tokens), **tkw)
    assert torch.equal(got_m, got)


def test_gemma2_window_bites_past_its_width():
    """At S = 40 the even (local) layers' window of 32 masks keys: the
    forward differs from the same weights with the window off, and the
    port still matches the reference (test_forward_matches_reference)."""
    cfg, _ = _cfgs("gemma2_9b")
    assert cfg.window == 32 and cfg.local_global_alternate
    assert [tT.layer_window(cfg, i) for i in range(cfg.n_layers)] == \
        [32, None, 32, None]
    _, model = _weights("gemma2_9b")
    tokens = torch.from_numpy(_tokens(cfg, 40))
    local, _ = tT.forward(model, cfg, tokens)
    wide, _ = tT.forward(model, dataclasses.replace(cfg, window=None),
                         tokens)
    # positions < 32 see every key either way; later ones lose some
    assert _rel(local[:, :32], wide[:, :32]) < 1e-6
    assert _rel(local[:, 32:], wide[:, 32:]) > 1e-3


def test_causal_mask_window_matches_reference():
    for q_len, kv, off, win in ((4, 4, 0, 2), (3, 9, 5, 4), (1, 16, 15, 3),
                                (6, 6, 0, None)):
        assert np.array_equal(
            causal_mask(q_len, kv, off, window=win).numpy(),
            np.asarray(r_causal_mask(q_len, kv, window=win, q_offset=off)))
    rows = causal_mask(3, 9, torch.tensor([0, 5]), window=4)
    assert torch.equal(rows[1], causal_mask(3, 9, 5, window=4))


@pytest.mark.parametrize("window,is_causal", [(7, True), (None, False),
                                              (7, False)])
def test_online_attention_with_window_matches_reference(window, is_causal):
    """The port's `_sdpa_online` masks every KV block by causality and the
    window as the reference's does, across KV blocks (KV_BLOCK shrunk),
    and equals the dense `_sdpa` on the same mask."""
    rng = np.random.default_rng(3)
    # three KV blocks of 128 (the block never drops below 128 keys)
    b, sq, skv, h, hd, kvh, off = 2, 24, 300, 4, 16, 2, 270
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    old = tA.KV_BLOCK, rA.KV_BLOCK
    tA.KV_BLOCK = rA.KV_BLOCK = 16
    try:
        got = tA._sdpa_online(tq, tk, tv, 5.0, 0.25, q_offset=off,
                              window=window, is_causal=is_causal)
        want = rA._sdpa_online(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               5.0, 0.25, q_offset=off, window=window,
                               is_causal=is_causal)
        rows = tA._sdpa_online(tq, tk, tv, 5.0, 0.25,
                               q_offset=torch.tensor([off, off]),
                               window=window, is_causal=is_causal)
    finally:
        tA.KV_BLOCK, rA.KV_BLOCK = old
    assert _rel(got, want) < 1e-5
    torch.testing.assert_close(rows, got, rtol=0, atol=0)
    mask = tA._kv_mask(sq, skv, off, window, is_causal, "cpu")
    dense = tA._sdpa(tq, tk, tv, mask, 5.0, 0.25)
    torch.testing.assert_close(got, dense, rtol=2e-5, atol=2e-5)


def _decode(step, caches, tokens):
    outs = []
    for t in range(tokens.shape[1]):
        lg, caches = step(tokens[:, t:t + 1], caches, t)
        outs.append(np.asarray(lg)[:, 0])
    return np.stack(outs, 1)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_reference_decode(arch):
    cfg, rcfg = _cfgs(arch)
    jp, model = _weights(arch)
    s = SEQ.get(arch, 10)
    tokens = _tokens(cfg, s)
    want = _decode(lambda tok, c, t: rT.forward(
        jp, rcfg, jnp.asarray(tok), caches=c, cache_pos=t),
        rT.init_caches(rcfg, B, s), tokens)
    caches = tT.init_caches(cfg, B, s, device="cpu")
    got = _decode(lambda tok, c, t: tT.forward(
        model, cfg, torch.from_numpy(tok), caches=c, cache_pos=t),
        caches, tokens)
    assert _rel(got, want) < TOL
    assert caches["k"].abs().max() > 0          # written in place


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_full_forward(arch):
    """As tests/test_models.py::test_decode_matches_full_forward holds the
    reference: token by token equals the full forward within 2e-3 (the
    vlm family's backbone without a prefix)."""
    cfg, _ = _cfgs(arch)
    _, model = _weights(arch)
    s = SEQ.get(arch, 10)
    tokens = _tokens(cfg, s)
    full, _ = tT.forward(model, cfg, torch.from_numpy(tokens))
    inc = _decode(lambda tok, c, t: tT.forward(
        model, cfg, torch.from_numpy(tok), caches=c, cache_pos=t),
        tT.init_caches(cfg, B, s, device="cpu"), tokens)
    assert _rel(inc, full.numpy()) < 2e-3


@pytest.mark.parametrize("arch", ["gemma2_9b", "minicpm_2b"])
def test_prefill_then_decode(arch):
    """As tests/test_train_serve.py::test_prefill_then_decode: the
    full-sequence `prefill_step` (one forward at cache_pos=0), then one
    `decode_step`, equals the full forward at that position within 2e-3;
    the prefill equals the reference's `prefill_step` within 1e-4."""
    cfg, rcfg = _cfgs(arch)
    jp, model = _weights(arch)
    tokens = _tokens(cfg, 8, seed=7)
    caches = tT.init_caches(cfg, B, 12, device="cpu")
    last, caches = tS.prefill_step(model, cfg, torch.from_numpy(tokens),
                                   caches)
    ref_last, _ = rS.prefill_step(jp, rcfg, jnp.asarray(tokens),
                                  rT.init_caches(rcfg, B, 12))
    assert _rel(last, ref_last) < TOL
    nxt = last.argmax(-1).to(torch.int32)[:, None]
    lg, caches = tS.decode_step(model, cfg, nxt, caches, 8)
    assert lg.shape == (B, cfg.vocab_pad)
    full, _ = tT.forward(model, cfg, torch.cat(
        [torch.from_numpy(tokens), nxt], 1))
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_prefill_step_stepwise_equals_one_forward():
    """`stepwise=True` (the batcher's prefill, as the JAX batcher runs it)
    fills the same cache and ends at the same logits as the one-forward
    prefill."""
    cfg, _ = _cfgs("minicpm_2b")
    _, model = _weights("minicpm_2b")
    tokens = torch.from_numpy(_tokens(cfg, 9, seed=8))
    one = tT.init_caches(cfg, B, 12, device="cpu")
    step = tT.init_caches(cfg, B, 12, device="cpu")
    last1, _ = tS.prefill_step(model, cfg, tokens, one)
    last2, _ = tS.prefill_step(model, cfg, tokens, step, stepwise=True)
    assert _rel(last2, last1) < 1e-5
    for name in ("k", "v"):
        assert _rel(step[name], one[name]) < 1e-5


@pytest.mark.parametrize("arch", ["minicpm_2b", "gemma2_9b"])
def test_per_row_cursors_equal_rows_run_alone(arch):
    """A (B,) cursor tensor: each row decodes at its own position exactly
    as it does alone (gemma2: past its window)."""
    cfg, _ = _cfgs(arch)
    _, model = _weights(arch)
    s = 40
    tokens = _tokens(cfg, s)
    lead = 5                      # row 1 runs ahead

    def step(tok, caches, pos):
        return tT.forward(model, cfg, torch.from_numpy(tok), caches=caches,
                          cache_pos=pos)[0][:, 0]

    caches = tT.init_caches(cfg, B, s, device="cpu")
    solo = [tT.init_caches(cfg, 1, s, device="cpu") for _ in range(B)]
    row1 = {k: v[:, 1:2] for k, v in caches.items()}
    for t in range(lead):
        step(tokens[1:2, t:t + 1], row1, t)
        step(tokens[1:2, t:t + 1], solo[1], t)
    for t in range(s - lead):
        pos = np.array([t, t + lead])
        tok = tokens[np.arange(B), pos][:, None]
        got = step(tok, caches, torch.from_numpy(pos))
        for r in range(B):
            want = step(tok[r:r + 1], solo[r], int(pos[r]))
            assert _rel(got[r], want[0]) < 1e-5


@pytest.mark.parametrize("arch", PORTED)
def test_device_rule(arch):
    """Every ported family: ``device=None`` means CUDA and raises without
    a card; ``device="cpu"`` runs."""
    cfg, _ = _cfgs(arch)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tT.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tT.init_caches(cfg, 1, 8)
    model = tT.init_params(cfg, 0, device="cpu")
    prefix = _prefix(cfg)
    kw = ({} if prefix is None
          else {"prefix_embeds": torch.from_numpy(prefix[:1])})
    logits, _ = model(torch.zeros(1, 4, dtype=torch.long), **kw)
    assert logits.shape == (1, 4 + cfg.n_prefix_embeds, cfg.vocab_pad)
    assert torch.isfinite(logits).all()
