"""Port parity for the serve stack at the reduced configs: on the hybrid
(zamba2), the dense (minicpm) and MoE (llama4-scout, deepseek-v2)
decoders, the ssm (rwkv6) and audio (whisper) families, greedy outputs of
the port's continuous batcher equal the JAX batcher's on the same
weights, slot isolation (batched equals solo, including reused slots),
and the budget and capacity edges of tests/test_train_serve.py."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as r_get_config
from repro.models import transformer as rT
from repro.serve import batching as rB

from repro_torch import obs
from repro_torch.configs.base import get_config
from repro_torch.models import transformer as tT
from repro_torch.models.weights import params_from_jax
from repro_torch.serve import batching as tB
from repro_torch.serve.serve_step import greedy_token

CFG = get_config("zamba2_2p7b").reduced()
RCFG = r_get_config("zamba2_2p7b").reduced()
# the prompts of tests/test_train_serve.py::test_batcher_slot_isolation_...
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [1], [2, 3, 4, 5, 6]]


@pytest.fixture(scope="module")
def weights():
    jp = rT.init_params(RCFG, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return jp, model


def _solo(model, prompt, max_new, max_len=32, cfg=CFG):
    (req,) = tB.serve_requests(model, cfg, [prompt], batch_slots=1,
                               max_len=max_len, max_new=max_new)
    return req.out


def test_serve_requests_matches_jax_batcher(weights):
    """One slot per prompt, so no slot is reused: the port zeroes a reused
    slot's Mamba2 state and conv tail, which the JAX batcher carries over,
    so reused slots differ from the reference by design (their correctness
    is `test_reused_slot_prefill_starts_from_a_clean_state`'s).  Greedy
    outputs are equal, and each prefill's last-position logits agree with
    the JAX batcher's prefill (`_step1` token by token on a fresh slot
    view) within 1e-4 of max |logits|."""
    jp, model = weights
    slots = len(PROMPTS)
    want = rB.serve_requests(jp, RCFG, PROMPTS, batch_slots=slots,
                             max_len=32, max_new=6)
    got = tB.serve_requests(model, CFG, PROMPTS, batch_slots=slots,
                            max_len=32, max_new=6)
    assert all(r.done for r in got)
    assert [r.out for r in got] == [r.out for r in want]
    for r, prompt in zip(got, PROMPTS):
        ref = _jax_batcher_prefill(jp, RCFG, prompt)
        err = np.abs(r.logits.numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-4, (r.rid, err)


def test_batcher_slot_isolation_matches_solo(weights):
    _, model = weights
    refs = [_solo(model, p, 6) for p in PROMPTS]
    reqs = tB.serve_requests(model, CFG, PROMPTS, batch_slots=3, max_len=32,
                             max_new=6)
    assert all(r.done for r in reqs)
    for r, ref in zip(reqs, refs):
        assert r.out == ref, (r.rid, r.out, ref)


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "rwkv6_7b"])
def test_reused_slot_prefill_starts_from_a_clean_state(weights, arch):
    """5 requests through 2 slots: every prefill, in a fresh or a reused
    slot, ends at the full forward's last-position logits, and every
    output equals the request served alone.  (The Mamba2 state and conv
    tail, and rwkv6's ``prev``, ``wkv`` and ``prev_cm``, are not indexed
    by position, so a reused slot must reset them.)"""
    cfg, model = ((CFG, weights[1]) if arch == "zamba2_2p7b"
                  else _decoder(arch)[::3])
    stream = [(0, [1, 2, 3], 2), (0, [4, 5], 5), (1, [6, 7, 8], 3),
              (4, [9, 1], 4), (6, [2, 2, 2, 2], 2)]
    reqs = tB.serve_stream(model, cfg, stream, batch_slots=2, max_len=32)
    for r, (_, p, mn) in zip(reqs, stream):
        assert r.done and r.out == _solo(model, p, mn, cfg=cfg), r.rid
        full, _ = tT.forward(model, cfg, torch.tensor([p]))
        want = full[0, -1]
        assert float((r.logits - want).abs().max()
                     / want.abs().max()) < 2e-3, r.rid


def test_batcher_budget_and_capacity_edges(weights):
    _, model = weights
    # max_new=1: exactly the prefill token, slot never occupied afterwards
    reqs = tB.serve_requests(model, CFG, [[1, 2], [3, 4]], batch_slots=2,
                             max_len=32, max_new=1)
    assert all(r.done and len(r.out) == 1 for r in reqs)
    # max_new=0: done immediately, nothing generated
    reqs = tB.serve_requests(model, CFG, [[1, 2]], batch_slots=2,
                             max_len=32, max_new=0)
    assert reqs[0].done and reqs[0].out == []
    # generation stops at cache capacity even with budget left
    reqs = tB.serve_requests(model, CFG, [list(range(1, 13))],
                             batch_slots=1, max_len=16, max_new=50)
    assert reqs[0].done and len(reqs[0].out) == 16 - 12
    # a prompt that cannot fit is rejected loudly, not silently clobbered
    b = tB.ContinuousBatcher(model, CFG, 1, max_len=8)
    with pytest.raises(ValueError):
        b.add(tB.Request(0, np.arange(1, 10, dtype=np.int32), max_new=4))


def test_serve_steps_emit_ambient_spans(weights):
    _, model = weights
    rec = obs.Recorder("serve")
    with obs.use(rec):
        tB.serve_requests(model, CFG, [[1, 2, 3]], batch_slots=1,
                          max_len=16, max_new=3)
    names = [e["name"] for e in rec.events if e["ph"] == "B"]
    assert names.count("serve/prefill_step") == 1
    assert names.count("serve/decode_step") == 2       # max_new - 1


def test_greedy_and_sampled_tokens():
    logits = torch.tensor([[0.0, 2.0, 1.0], [5.0, -1.0, 0.0]])
    assert greedy_token(logits).tolist() == [1, 0]
    with pytest.raises(ValueError, match="generator"):
        greedy_token(logits, temperature=1.0)
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    a = greedy_token(logits, 1.0, generator=g1)
    assert a.dtype == torch.int32 and torch.equal(
        a, greedy_token(logits, 1.0, generator=g2))


# -- the dense and MoE families (position-indexed caches) -------------------

DECODERS = ["minicpm_2b", "llama4_scout_17b_a16e", "deepseek_v2_236b"]


def _decoder(arch):
    """Reduced config, its reference twin, the reference's weights
    (PRNGKey 0, as tests/test_train_serve.py) and the port holding them."""
    cfg, rcfg = get_config(arch).reduced(), r_get_config(arch).reduced()
    jp = rT.init_params(rcfg, jax.random.PRNGKey(0))
    return cfg, rcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                          device="cpu")


def _jax_batcher_prefill(jp, rcfg, prompt):
    """The JAX batcher's prefill of ``prompt``: `_step1` token by token on
    a fresh slot view; the last logits."""
    view = rT.init_caches(rcfg, 1, 32)
    for t, tok in enumerate(prompt):
        lg, view = rB._step1(jp, rcfg, jnp.full((1, 1), tok, jnp.int32),
                             view, jnp.int32(t))
    return np.asarray(lg[0])


@pytest.mark.parametrize("arch", DECODERS)
def test_decoder_batcher_matches_jax_batcher(arch):
    """Three slots for five prompts (slots are reused: the caches are
    indexed by position, so nothing carries over): greedy outputs equal
    the JAX batcher's, the MoE families' included (the port's batched
    decode dispatches each slot alone, as the JAX batcher's per-slot
    decode does), and each prefill's last-position logits agree with the
    JAX batcher's token-by-token prefill within 1e-4 of max |logits|."""
    cfg, rcfg, jp, model = _decoder(arch)
    want = rB.serve_requests(jp, rcfg, PROMPTS, batch_slots=3, max_len=32,
                             max_new=6)
    got = tB.serve_requests(model, cfg, PROMPTS, batch_slots=3, max_len=32,
                            max_new=6)
    assert all(r.done for r in got)
    assert [r.out for r in got] == [r.out for r in want]
    for r, prompt in zip(got, PROMPTS):
        ref = _jax_batcher_prefill(jp, rcfg, prompt)
        err = np.abs(r.logits.numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-4, (r.rid, err)


def test_decoder_slot_isolation_matches_solo():
    """minicpm: batched equals solo, in fresh and reused slots, and each
    prefill ends at the full forward's last-position logits (2e-3)."""
    cfg, _, _, model = _decoder("minicpm_2b")
    stream = [(0, [1, 2, 3], 2), (0, [4, 5], 5), (1, [6, 7, 8], 3),
              (4, [9, 1], 4), (6, [2, 2, 2, 2], 2)]
    reqs = tB.serve_stream(model, cfg, stream, batch_slots=2, max_len=32)
    for r, (_, p, mn) in zip(reqs, stream):
        (solo,) = tB.serve_requests(model, cfg, [p], batch_slots=1,
                                    max_len=32, max_new=mn)
        assert r.done and r.out == solo.out, r.rid
        full, _ = tT.forward(model, cfg, torch.tensor([p]))
        want = full[0, -1]
        assert float((r.logits - want).abs().max()
                     / want.abs().max()) < 2e-3, r.rid


@pytest.mark.parametrize("arch", ["rwkv6_7b", "whisper_medium"])
def test_ssm_and_audio_batchers_match_jax_batcher(arch):
    """One slot per prompt, every request arriving at tick 0: no slot is
    reused or idle before its prefill, the one stream on which the JAX
    batcher (which carries a slot's rwkv6 state over and advances idle
    slots) and the port's (which zeroes it) agree.  Neither batcher takes
    audio, so whisper's cross-attention reads zero K/V in both.  Greedy
    outputs are equal, and each prefill's last-position logits agree
    with the JAX batcher's within 1e-4 of max |logits|."""
    cfg, rcfg, jp, model = _decoder(arch)
    slots = len(PROMPTS)
    want = rB.serve_requests(jp, rcfg, PROMPTS, batch_slots=slots,
                             max_len=32, max_new=6)
    got = tB.serve_requests(model, cfg, PROMPTS, batch_slots=slots,
                            max_len=32, max_new=6)
    assert all(r.done for r in got)
    assert [r.out for r in got] == [r.out for r in want]
    for r, prompt in zip(got, PROMPTS):
        ref = _jax_batcher_prefill(jp, rcfg, prompt)
        err = np.abs(r.logits.numpy() - ref).max() / np.abs(ref).max()
        assert err < 1e-4, (r.rid, err)


def test_prefill_step_with_prefix_embeds_matches_reference():
    """internvl2 ``reduced()``: ``prefill_step(prefix_embeds=)`` caches the
    8 prefix embeddings at positions 0..7 before the prompt, and two
    ``decode_step``s from position P + L give the reference's
    ``prefill_step``/``decode_step`` logits within 1e-4 of max |logits|;
    a stepwise prefill with a prefix is refused."""
    from repro.serve import serve_step as rS
    from repro_torch.serve import serve_step as tS
    arch = "internvl2_26b"
    rcfg, cfg = r_get_config(arch).reduced(), get_config(arch).reduced()
    jp = rT.init_params(rcfg, jax.random.PRNGKey(2))
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(4)
    b, n_pre, length = 2, cfg.n_prefix_embeds, 6
    toks = rng.integers(0, cfg.vocab, (b, length + 2)).astype(np.int32)
    prefix = (rng.standard_normal((b, n_pre, cfg.d_model)) * 0.1) \
        .astype(np.float32)
    smax = n_pre + length + 2
    rl, rc = rS.prefill_step(jp, rcfg, jnp.asarray(toks[:, :length]),
                             rT.init_caches(rcfg, b, smax),
                             prefix_embeds=jnp.asarray(prefix))
    caches = tT.init_caches(cfg, b, smax, device="cpu")
    tl, caches = tS.prefill_step(model, cfg, torch.from_numpy(
        toks[:, :length]), caches, prefix_embeds=torch.from_numpy(prefix))
    want, got = [np.asarray(rl)], [tl.numpy()]
    for i in range(2):
        pos = n_pre + length + i
        step = toks[:, length + i:length + i + 1]
        rl, rc = rS.decode_step(jp, rcfg, jnp.asarray(step), rc, pos)
        tl, caches = tS.decode_step(model, cfg, torch.from_numpy(step),
                                    caches, pos)
        want.append(np.asarray(rl))
        got.append(tl.numpy())
    want, got = np.stack(want), np.stack(got)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.raises(ValueError, match="prefix_embeds"):
        tS.prefill_step(model, cfg, torch.from_numpy(toks[:, :length]),
                        tT.init_caches(cfg, b, smax, device="cpu"),
                        stepwise=True, prefix_embeds=torch.from_numpy(prefix))
