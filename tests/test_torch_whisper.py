"""Port parity for the audio family (whisper) at the reduced config (2
encoder + 4 decoder layers, 32 frames): cross-attention and
``init_cross_kv``, the encoder, the full forward with and without frames
against the JAX package on the reference's own weights
(``params_from_jax``, ``enc_blocks`` split along ``enc_layers``),
``prefill_step(enc_frames=)`` then ``decode_step`` against the reference's
token-by-token loop and the port's own forward, the cross-attention cache
written at prefill and only read at decode, and per-row cursors."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as r_get_config
from repro.models import attention as rA
from repro.models import transformer as rT

from repro_torch.configs.base import get_config
from repro_torch.models import attention as tA
from repro_torch.models import transformer as tT
from repro_torch.models.weights import params_from_jax
from repro_torch.serve import serve_step as tS

CFG = get_config("whisper_medium").reduced()
RCFG = r_get_config("whisper_medium").reduced()
B, S, F = 2, 10, 32


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


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(6).standard_normal(
        (B, F, CFG.d_model)).astype(np.float32)


def test_config_and_parameter_count():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(RCFG)
    assert (CFG.enc_layers, CFG.n_layers, CFG.enc_positions) == (2, 4, F)
    full = get_config("whisper_medium")
    d, f = full.d_model, full.d_ff
    attn, mlp = 4 * d * d, 3 * d * f
    n = (full.vocab_pad * d + 2 * d + full.n_layers * (2 * attn + mlp + 3 * d)
         + full.enc_layers * (attn + mlp + 2 * d))
    assert (full.vocab_pad, n) == (52224, 959_571_968)


def test_params_from_jax_splits_enc_blocks(weights):
    jp, model = weights
    assert type(model) is tT.DecoderLM
    assert (len(model.blocks), len(model.enc_blocks)) == (CFG.n_layers,
                                                         CFG.enc_layers)
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    np.testing.assert_array_equal(
        model.enc_blocks[1].attn.wq.numpy(),
        np.asarray(jp["enc_blocks"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(
        model.blocks[3].xattn.wv.numpy(),
        np.asarray(jp["blocks"]["xattn"]["wv"][3]))
    names = model.state_dict()
    for name in ("enc_blocks.1.mlp.w_up", "enc_final_gamma",
                 "blocks.3.ln_x", "blocks.3.xattn.wq"):
        assert name in names
    assert not any(n.startswith("enc_blocks.0.xattn") for n in names)
    own = tT.init_params(CFG, 0, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in names.items()}


def test_cross_attention_matches_reference(weights, frames):
    """``init_cross_kv`` and ``attention(..., kv_override=)``: every key
    attended, q not rotated (the output does not depend on the query's
    positions), no cache written."""
    jp, model = weights
    rp = jax.tree.map(lambda a: a[2], jp["blocks"]["xattn"])
    tp = model.blocks[2].xattn
    x = np.random.default_rng(7).standard_normal(
        (B, 5, CFG.d_model)).astype(np.float32)
    rkv = rA.init_cross_kv(rp, jnp.asarray(frames), RCFG)
    tkv = tA.init_cross_kv(tp, torch.from_numpy(frames), CFG)
    for got, want in zip(tkv, rkv):
        assert got.shape == (B, F, CFG.n_kv_heads, CFG.hd)
        assert _rel(got, want) < 1e-6
    pos = np.arange(5)
    want, wc = rA.attention(rp, jnp.asarray(x), RCFG, jnp.asarray(pos),
                            is_causal=False, kv_override=rkv)
    got, tc = tA.attention(tp, torch.from_numpy(x), CFG,
                           torch.from_numpy(pos), kv_override=tkv)
    assert wc is None and tc is None
    assert _rel(got, want) < 1e-5
    moved, _ = tA.attention(tp, torch.from_numpy(x), CFG,
                            torch.from_numpy(pos + 100), kv_override=tkv)
    assert torch.equal(moved, got)


def test_encoder_matches_reference(weights, frames):
    jp, model = weights
    want = rT._run_encoder(jp, RCFG, jnp.asarray(frames), "none")
    got = tT._run_encoder(model, CFG, torch.from_numpy(frames))
    assert got.shape == (B, F, CFG.d_model)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("with_frames", [True, False])
def test_forward_matches_reference(weights, tokens, frames, with_frames):
    """With frames the encoder runs and every decoder block
    cross-attends; without them (and without a cache) the decoder has no
    cross term, as in the reference."""
    jp, model = weights
    rkw = {"enc_frames": jnp.asarray(frames)} if with_frames else {}
    tkw = {"enc_frames": torch.from_numpy(frames)} if with_frames else {}
    want, _ = rT.forward(jp, RCFG, jnp.asarray(tokens), **rkw)
    got, caches = tT.forward(model, CFG, torch.from_numpy(tokens), **tkw)
    assert caches is None
    assert got.shape == (B, S, CFG.vocab_pad) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-4
    got_m, _ = model(torch.from_numpy(tokens), **tkw)
    assert torch.equal(got_m, got)


def _reference_loop(jp, tokens, frames):
    """tests/test_models.py::test_decode_matches_full_forward's loop: one
    token per call, the frames with token 0."""
    caches = rT.init_caches(RCFG, B, S)
    outs = []
    for t in range(S):
        kw = {"enc_frames": jnp.asarray(frames)} if t == 0 else {}
        lg, caches = rT.forward(jp, RCFG, jnp.asarray(tokens[:, t:t + 1]),
                                caches=caches, cache_pos=t, **kw)
        outs.append(np.asarray(lg[:, 0]))
    return np.stack(outs, 1)


def test_prefill_then_decode_matches_reference(weights, tokens, frames):
    """`prefill_step` of the first 4 tokens with the frames (one forward
    at cache_pos=0), then `decode_step` of the rest without them: within
    1e-4 of the reference's loop and 2e-3 of the port's full forward; the
    cross cache is written at prefill and unchanged by decode."""
    jp, model = weights
    want = _reference_loop(jp, tokens, frames)
    caches = tT.init_caches(CFG, B, S, device="cpu")
    t_tok = torch.from_numpy(tokens)
    last, caches = tS.prefill_step(model, CFG, t_tok[:, :4], caches,
                                   enc_frames=torch.from_numpy(frames))
    enc = tT._run_encoder(model, CFG, torch.from_numpy(frames))
    for i, blk in enumerate(model.blocks):
        xk, xv = tA.init_cross_kv(blk.xattn, enc, CFG)
        assert _rel(caches["xk"][i], xk) < 1e-6
        assert _rel(caches["xv"][i], xv) < 1e-6
    xk0, xv0 = caches["xk"].clone(), caches["xv"].clone()
    outs = [last]
    for t in range(4, S):
        lg, caches = tS.decode_step(model, CFG, t_tok[:, t:t + 1], caches, t)
        outs.append(lg)
    got = torch.stack(outs, 1)
    assert _rel(got, want[:, 3:]) < 1e-4
    full, _ = tT.forward(model, CFG, t_tok,
                         enc_frames=torch.from_numpy(frames))
    assert _rel(got, full[:, 3:]) < 2e-3
    assert torch.equal(caches["xk"], xk0) and torch.equal(caches["xv"], xv0)


def test_stepwise_prefill_with_frames_equals_one_forward(weights, frames):
    """`stepwise=True` gives the frames to token 0 only, and fills the same
    caches as the one-forward prefill."""
    _, model = weights
    toks = torch.from_numpy(
        np.random.default_rng(8).integers(0, CFG.vocab, (B, 7)))
    one = tT.init_caches(CFG, B, 12, device="cpu")
    step = tT.init_caches(CFG, B, 12, device="cpu")
    fr = torch.from_numpy(frames)
    last1, _ = tS.prefill_step(model, CFG, toks, one, enc_frames=fr)
    last2, _ = tS.prefill_step(model, CFG, toks, step, stepwise=True,
                               enc_frames=fr)
    assert _rel(last2, last1) < 1e-5
    for name in ("k", "v", "xk", "xv"):
        assert _rel(step[name], one[name]) < 1e-5


def test_frames_must_fit_the_cross_cache(weights, frames):
    _, model = weights
    caches = tT.init_caches(CFG, B, 8, device="cpu", enc_len=F // 2)
    assert caches["xk"].shape == (CFG.n_layers, B, F // 2, CFG.n_kv_heads,
                                  CFG.hd)
    with pytest.raises(ValueError, match="enc_len"):
        tS.prefill_step(model, CFG, torch.zeros(B, 2, dtype=torch.long),
                        caches, enc_frames=torch.from_numpy(frames))
    short = tT.init_caches(CFG, B, 8, device="cpu", enc_len=F // 2)
    tS.prefill_step(model, CFG, torch.zeros(B, 2, dtype=torch.long), short,
                    enc_frames=torch.from_numpy(frames[:, :F // 2]))
    assert short["xk"].abs().max() > 0


def test_per_row_cursors_equal_rows_run_alone(weights, tokens, frames):
    """A batched decode step with (B,) cursors, rows at different
    positions of their self-attention caches, each cross-attending to its
    own frames, equals each row decoded alone."""
    _, model = weights
    lead = 3
    caches = tT.init_caches(CFG, B, S, device="cpu")
    solo = [tT.init_caches(CFG, 1, S, device="cpu") for _ in range(B)]
    fr = torch.from_numpy(frames)
    t_tok = torch.from_numpy(tokens)
    for r, n in enumerate((1, 1 + lead)):
        view = {k: v[:, r:r + 1] for k, v in caches.items()}
        tS.prefill_step(model, CFG, t_tok[r:r + 1, :n], view,
                        enc_frames=fr[r:r + 1])
        tS.prefill_step(model, CFG, t_tok[r:r + 1, :n], solo[r],
                        enc_frames=fr[r:r + 1])
    for t in range(1, S - lead):
        pos = np.array([t, t + lead])
        tok = t_tok[np.arange(B), pos][:, None]
        got, _ = tS.decode_step(model, CFG, tok, caches,
                                torch.from_numpy(pos))
        for r in range(B):
            want, _ = tS.decode_step(model, CFG, tok[r:r + 1], solo[r],
                                     int(pos[r]))
            assert _rel(got[r], want[0]) < 1e-5
