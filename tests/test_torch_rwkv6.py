"""Port parity for the ssm family (rwkv6) at the reduced config (4 layers,
d 64, heads of 32): the chunked WKV, the time and channel mixes with and
without a state, the full forward and token-by-token decode against the
JAX package on the reference's own weights (``params_from_jax``), the
port's decode and ``prefill_step`` against its own forward, the decay
clip, and the refusal of a multi-token step with a state."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as r_get_config
from repro.models import rwkv6 as rR6
from repro.models import transformer as rT

from repro_torch.configs.base import get_config
from repro_torch.models import rwkv6 as tR6
from repro_torch.models import transformer as tT
from repro_torch.models.layers import ParamTree
from repro_torch.models.weights import params_from_jax
from repro_torch.serve import serve_step as tS

CFG = get_config("rwkv6_7b").reduced()
RCFG = r_get_config("rwkv6_7b").reduced()
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


def _layer(jp, i, name):
    return jax.tree.map(lambda a: a[i], jp["blocks"][name])


def _x(seed, length, b=B):
    return np.random.default_rng(seed).standard_normal(
        (b, length, CFG.d_model)).astype(np.float32)


def test_config_and_parameter_count():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(RCFG)
    assert (CFG.n_layers, CFG.d_model, CFG.ssm_head_dim) == (4, 64, 32)
    full = get_config("rwkv6_7b")
    # the published config's count (the reference pytree's shapes)
    d, f, lora = full.d_model, full.d_ff, tR6.LORA
    tmix = 5 * d + 5 * d * d + 2 * d * lora + 3 * d
    cmix = 2 * d + d * d + 2 * d * f
    n = full.vocab_pad * d + d + full.n_layers * (tmix + cmix + 2 * d)
    assert n == 7_266_111_488


def test_params_from_jax_maps_every_leaf(weights):
    jp, model = weights
    assert type(model) is tT.DecoderLM and len(model.blocks) == CFG.n_layers
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    np.testing.assert_array_equal(model.blocks[2].tmix.wr.numpy(),
                                  np.asarray(jp["blocks"]["tmix"]["wr"][2]))
    names = model.state_dict()
    assert "blocks.2.tmix.wr" in names and "blocks.2.cmix.wv" in names
    assert model.blocks[0].tmix.w0.dtype == torch.float32
    # the port's own init has the reference's tree
    own = tT.init_params(CFG, 0, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in names.items()}


@pytest.mark.parametrize("length", [10, 16, 37])
def test_wkv_chunked_matches_reference(length):
    """Lengths below, at and past the chunk of 16 (37 pads to 48)."""
    rng = np.random.default_rng(length)
    r, k, v = (rng.standard_normal((B, length, CFG.d_model))
               .astype(np.float32) for _ in range(3))
    logw = -rng.uniform(1e-4, 4.0, (B, length, CFG.d_model)) \
        .astype(np.float32)
    u = rng.standard_normal(CFG.d_model).astype(np.float32) * 0.5
    want = rR6._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                            CFG.ssm_head_dim)
    got = tR6._wkv_chunked(*(torch.from_numpy(a) for a in (r, k, v, logw,
                                                           u)),
                           CFG.ssm_head_dim)
    assert got.shape == (B, length, CFG.d_model)
    assert _rel(got, want) < 1e-5


def _mixer_pair(jp, model, mixer, layer=1):
    if mixer == "time":
        return (lambda x, st: rR6.rwkv6_time_mix(
                    _layer(jp, layer, "tmix"), x, RCFG, st),
                lambda x, st: tR6.rwkv6_time_mix(
                    model.blocks[layer].tmix, x, CFG, st))
    return (lambda x, st: rR6.rwkv6_channel_mix(
                _layer(jp, layer, "cmix"), x, st),
            lambda x, st: tR6.rwkv6_channel_mix(
                model.blocks[layer].cmix, x, st))


@pytest.mark.parametrize("mixer", ["time", "channel"])
def test_mixer_matches_reference_without_state(weights, mixer):
    jp, model = weights
    ref, port = _mixer_pair(jp, model, mixer)
    x = _x(2, 37)
    want, want_st = ref(jnp.asarray(x), None)
    got, got_st = port(torch.from_numpy(x), None)
    assert want_st is None and got_st is None
    assert got.shape == (B, 37, CFG.d_model)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("mixer", ["time", "channel"])
def test_mixer_matches_reference_with_state(weights, mixer):
    """Three one-token steps from a non-zero state: outputs and every
    state leaf against the reference's."""
    jp, model = weights
    ref, port = _mixer_pair(jp, model, mixer)
    rng = np.random.default_rng(3)
    h = CFG.d_model // CFG.ssm_head_dim
    prev = rng.standard_normal((B, CFG.d_model)).astype(np.float32)
    wkv = rng.standard_normal((B, h, CFG.ssm_head_dim, CFG.ssm_head_dim)) \
        .astype(np.float32)
    if mixer == "time":
        r_st = {"prev": jnp.asarray(prev), "wkv": jnp.asarray(wkv)}
        t_st = {"prev": torch.from_numpy(prev), "wkv": torch.from_numpy(wkv)}
    else:
        r_st, t_st = jnp.asarray(prev), torch.from_numpy(prev)
    xs = _x(4, 3)
    for t in range(3):
        want, r_st = ref(jnp.asarray(xs[:, t:t + 1]), r_st)
        got, t_st = port(torch.from_numpy(xs[:, t:t + 1]), t_st)
        assert _rel(got, want) < 1e-5
        for name in (("prev", "wkv") if mixer == "time" else (None,)):
            g = t_st if name is None else t_st[name]
            w = r_st if name is None else r_st[name]
            assert g.dtype == torch.float32 and _rel(g, w) < 1e-5


@pytest.mark.parametrize("mixer", ["time", "channel"])
def test_stateful_call_with_several_tokens_raises(weights, mixer):
    """The reference reads token 0 of a multi-token step and broadcasts
    one row over all positions; the port refuses."""
    _, model = weights
    st = tR6.init_rwkv6_state(CFG, 1)
    x = torch.zeros(1, 3, CFG.d_model)
    with pytest.raises(ValueError, match="one step"):
        if mixer == "time":
            tR6.rwkv6_time_mix(model.blocks[0].tmix, x, CFG,
                               {"prev": st["prev"], "wkv": st["wkv"]})
        else:
            tR6.rwkv6_channel_mix(model.blocks[0].cmix, x, st["prev_cm"])


@pytest.mark.parametrize("w0,beyond", [(5.0, 6.0), (-15.0, -20.0)])
def test_decay_clip_binds_as_in_reference(weights, w0, beyond):
    """With ``w0`` set so that logw = −exp(w0 + δ) lies past LOGW_MIN
    (w0 = 5) or above −1e-4 (w0 = −15) at every position, the port
    matches the reference, and moving ``w0`` further out changes nothing:
    the clip binds everywhere."""
    jp, model = weights
    x = _x(6, 21)
    outs = []
    for w in (w0, beyond):
        rp = dict(_layer(jp, 0, "tmix"))
        rp["w0"] = jnp.full_like(rp["w0"], w)
        tp = ParamTree({k: torch.tensor(np.asarray(v))
                        for k, v in rp.items()})
        want, _ = rR6.rwkv6_time_mix(rp, jnp.asarray(x), RCFG)
        got, _ = tR6.rwkv6_time_mix(tp, torch.from_numpy(x), CFG)
        assert _rel(got, want) < 1e-5
        outs.append(got)
    assert torch.equal(outs[0], outs[1])


def test_forward_matches_reference(weights, tokens):
    jp, model = weights
    want, _ = rT.forward(jp, RCFG, jnp.asarray(tokens))
    got, caches = tT.forward(model, CFG, torch.from_numpy(tokens))
    assert caches is None
    assert got.shape == (B, S, CFG.vocab_pad) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-4
    got_m, _ = model(torch.from_numpy(tokens))
    assert torch.equal(got_m, got)


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
    caches = tT.init_caches(CFG, B, S, device="cpu")
    got = _decode(lambda tok, c, t: tT.forward(
        model, CFG, torch.from_numpy(tok), caches=c, cache_pos=t),
        caches, tokens)
    assert _rel(got, want) < 1e-4
    for name in ("prev", "wkv", "prev_cm"):       # written in place
        assert caches[name].dtype == torch.float32
        assert caches[name].abs().max() > 0


def test_decode_matches_full_forward(weights, tokens):
    """As tests/test_models.py::test_decode_matches_full_forward holds the
    reference: token by token equals the full forward within 2e-3."""
    _, model = weights
    full, _ = tT.forward(model, CFG, torch.from_numpy(tokens))
    inc = _decode(lambda tok, c, t: tT.forward(
        model, CFG, torch.from_numpy(tok), caches=c, cache_pos=t),
        tT.init_caches(CFG, B, S, device="cpu"), tokens)
    assert _rel(inc, full.numpy()) < 2e-3


def test_caches_do_not_grow_with_position():
    h = CFG.d_model // CFG.ssm_head_dim
    for max_len in (8, 4096):
        c = tT.init_caches(CFG, 3, max_len, dtype=torch.float64,
                           device="cpu")
        assert {k: tuple(v.shape) for k, v in c.items()} == {
            "prev": (CFG.n_layers, 3, CFG.d_model),
            "wkv": (CFG.n_layers, 3, h, CFG.ssm_head_dim, CFG.ssm_head_dim),
            "prev_cm": (CFG.n_layers, 3, CFG.d_model)}
        assert all(v.dtype == torch.float32 for v in c.values())


def test_prefill_step_runs_the_prompt_token_by_token(weights):
    """A 12-token prompt through `prefill_step` ends at the full
    forward's last-position logits, and the next `decode_step` continues
    it (the reference's one-forward prefill on rwkv6 reads token 0's
    state inputs only)."""
    _, model = weights
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(1, CFG.vocab, (2, 12)))
    caches = tT.init_caches(CFG, 2, 16, device="cpu")
    last, caches = tS.prefill_step(model, CFG, tokens, caches)
    full, _ = tT.forward(model, CFG, tokens)
    assert _rel(last, full[:, -1]) < 1e-5
    nxt = full[:, -1].argmax(-1)[:, None]
    step, _ = tS.decode_step(model, CFG, nxt, caches, 12)
    want, _ = tT.forward(model, CFG, torch.cat([tokens, nxt], 1))
    assert _rel(step, want[:, -1]) < 2e-3


def test_per_row_cursors_equal_rows_run_alone(weights, tokens):
    """The state ignores positions: a batched step with (B,) cursors,
    rows at different positions, equals each row decoded alone."""
    _, model = weights
    caches = tT.init_caches(CFG, B, S, device="cpu")
    solo = [tT.init_caches(CFG, 1, S, device="cpu") for _ in range(B)]
    row1 = {k: v[:, 1:2] for k, v in caches.items()}
    for t in range(3):                         # row 1 runs three ahead
        tT.forward(model, CFG, torch.from_numpy(tokens[1:2, t:t + 1]),
                   caches=row1, cache_pos=t)
        tT.forward(model, CFG, torch.from_numpy(tokens[1:2, t:t + 1]),
                   caches=solo[1], cache_pos=t)
    for t in range(S - 3):
        pos = np.array([t, t + 3])
        tok = torch.from_numpy(tokens[np.arange(B), pos][:, None])
        got, _ = tT.forward(model, CFG, tok, caches=caches,
                            cache_pos=torch.from_numpy(pos))
        for r in range(B):
            want, _ = tT.forward(model, CFG, tok[r:r + 1], caches=solo[r],
                                 cache_pos=int(pos[r]))
            assert _rel(got[r], want[0]) < 1e-5
