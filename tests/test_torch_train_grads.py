"""Gradient and update parity of the port's train step against the JAX
package, on the reduced configs with the reference's own init
(``params_from_jax``) and the same numpy batches: the next-token loss and
its gradient on every reference leaf (through ``weights.reference_tree``)
for minicpm, internvl2 (prefix), deepseek-v2 (MoE + MLA), zamba2 (the
chunked scan), rwkv6 and whisper (frames); AdamW on identical gradients,
its weight-decay set and the int8 compression's per-leaf scale; whole
train steps; and the three remat modes."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as r_get_config
from repro.models import transformer as rT
from repro.train import optimizer as rO
from repro.train import train_step as rTS

from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.models import transformer as tT
from repro_torch.models.weights import (leaf_groups, params_from_jax,
                                        reference_tree)
from repro_torch.serve import serve_step as tS
from repro_torch.train import optimizer as tO
from repro_torch.train import train_step as tTS

ARCHS = ["minicpm_2b", "internvl2_26b", "deepseek_v2_236b", "zamba2_2p7b",
         "rwkv6_7b", "whisper_medium"]
B, S = 2, 10
LOSS_TOL = 1e-5     # relative
GRAD_TOL = 1e-4     # of each reference leaf's max |g|
_MODELS = {}


def _cfgs(arch):
    return get_config(arch).reduced(), r_get_config(arch).reduced()


def _weights(arch):
    """The reference's init (PRNGKey 1) as numpy leaves, made once."""
    if arch not in _MODELS:
        _, rcfg = _cfgs(arch)
        _MODELS[arch] = jax.tree.map(
            np.asarray, rT.init_params(rcfg, jax.random.PRNGKey(1)))
    return _MODELS[arch]


def _model(arch, trainable=True):
    cfg, _ = _cfgs(arch)
    model = params_from_jax(_weights(arch), cfg, device="cpu")
    return model.requires_grad_(trainable)


def _batch(cfg, b=B, s=S, seed=5):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = (rng.standard_normal(
            (b, cfg.n_prefix_embeds, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.enc_layers:
        out["enc_frames"] = (rng.standard_normal(
            (b, cfg.enc_positions, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree):
    """{"blocks.attn.wq": array} of a reference pytree."""
    return {".".join(k.key for k in path): np.asarray(a) for path, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads(model):
    return reference_tree(model, {n: p.grad for n, p in
                                  model.named_parameters()})


def _worst(got: dict, want: dict) -> float:
    """The largest |got − want| of any leaf over that leaf's max |want|."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    return max(float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30))
               for k, w in want.items())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, rcfg = _cfgs(arch)
    batch = _batch(cfg)
    want_loss, want = jax.jit(jax.value_and_grad(rTS.next_token_loss),
                              static_argnums=(1, 3))(
        _weights(arch), rcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        "full")
    model = _model(arch)
    loss = tTS.next_token_loss(model, cfg, _torch(batch), "full")
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL * abs(
        float(want_loss))
    assert all(p.grad is not None for p in model.parameters())
    assert _worst(_grads(model), want) <= GRAD_TOL


def test_reference_tree_inverts_params_from_jax():
    for arch in ("zamba2_2p7b", "whisper_medium"):
        want = _leaves(_weights(arch))
        got = _leaves(reference_tree(_model(arch, trainable=False)))
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].shape == w.shape and np.array_equal(got[k], w), k


def test_leaf_groups_give_the_reference_leaf_ranks():
    for arch in ("zamba2_2p7b", "whisper_medium", "deepseek_v2_236b"):
        model = _model(arch, trainable=False)
        groups = leaf_groups(model)
        want = _leaves(_weights(arch))
        assert groups.keys() == want.keys()
        for path, leaf in groups.items():
            assert leaf.ndim == want[path].ndim, path
            stacked = path.split(".")[0] in ("blocks", "enc_blocks")
            assert len(leaf.names) == (want[path].shape[0] if stacked else 1)
        assert sorted(n for g in groups.values() for n in g.names) == \
            sorted(n for n, _ in model.named_parameters())


@pytest.mark.parametrize("arch", ["zamba2_2p7b", "whisper_medium"])
def test_weight_decay_set_follows_reference_leaf_rank(arch):
    """The reference decays ``p.ndim >= 2`` of its STACKED leaves: every
    per-layer vector (``blocks.ln1`` is (L, d)), but not ``final_gamma``
    nor zamba2's shared ``ln1``/``ln2``.  The port's per-layer tensors
    are one dim lower, so the set comes from `weights.leaf_groups`."""
    model = _model(arch, trainable=False)
    decayed = tO.decayed(model)
    want = {path for path, a in _leaves(_weights(arch)).items()
            if a.ndim >= 2}
    got = {path for path, leaf in leaf_groups(model).items()
           if set(leaf.names) <= decayed}
    assert got == want
    assert "blocks.0.ln1" in decayed and "final_gamma" not in decayed
    assert any(p.dim() == 1 and n in decayed
               for n, p in model.named_parameters())
    if arch == "zamba2_2p7b":
        assert "shared.ln1" not in decayed
        assert "blocks.0.mamba.d_skip" in decayed


@pytest.mark.parametrize("arch", ["minicpm_2b", "zamba2_2p7b"])
def test_adamw_update_matches_reference(arch):
    """Two updates on identical random gradients at the default eps: the
    parameters, ``mu`` and ``nu`` within 1e-6 of each leaf's max."""
    cfg, _ = _cfgs(arch)
    jp = _weights(arch)
    rng = np.random.default_rng(11)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape)
                          .astype(np.float32) * 0.01, jp) for _ in range(2)]
    ocfg = dict(peak_lr=1e-2, warmup_steps=3)
    rp, ropt = jp, rO.adamw_init(jp)
    model = _model(arch, trainable=False)
    topt = tO.adamw_init(model)
    update = jax.jit(rO.adamw_update, static_argnums=3)
    for g in grads:
        rp, ropt, rm = update(g, ropt, rp, rO.OptConfig(**ocfg))
        gm = params_from_jax(g, cfg, device="cpu")
        for (_, p), (_, gp) in zip(model.named_parameters(),
                                   gm.named_parameters()):
            p.grad = gp.detach().clone()
        tm = tO.adamw_update(model, topt, tO.OptConfig(**ocfg))
    assert int(topt["step"]) == int(ropt["step"]) == 2
    for key in ("lr", "grad_norm"):
        assert abs(float(tm[key]) - float(rm[key])) <= 1e-6 * abs(
            float(rm[key]))
    assert _worst(reference_tree(model), rp) <= 1e-6
    for moment in ("mu", "nu"):
        assert _worst(reference_tree(model, topt[moment]),
                      ropt[moment]) <= 1e-6


@pytest.mark.parametrize("arch", ["minicpm_2b", "zamba2_2p7b"])
def test_int8_compression_has_one_scale_per_reference_leaf(arch):
    """`compress_grads` on identical gradients and residuals equals the
    reference's ``_compress_int8`` of each stacked leaf: bit for bit."""
    cfg, _ = _cfgs(arch)
    jp = _weights(arch)
    rng = np.random.default_rng(12)
    # layers of very different scale: a per-layer max would differ
    g, err = (jax.tree.map(lambda a: (rng.standard_normal(a.shape) * np.exp(
        rng.standard_normal(a.shape[:1] + (1,) * (a.ndim - 1)) * 2))
        .astype(np.float32), jp) for _ in range(2))
    model = _model(arch, trainable=False)
    gm, em = (params_from_jax(t, cfg, device="cpu") for t in (g, err))
    for (_, p), (_, gp) in zip(model.named_parameters(),
                               gm.named_parameters()):
        p.grad = gp.detach().clone()
    err_t = {n: e.detach().clone() for n, e in em.named_parameters()}
    tTS.compress_grads(model, err_t)
    want = jax.tree.map(lambda a, e: rTS._compress_int8(jnp.asarray(a),
                                                        jnp.asarray(e)),
                        g, err, is_leaf=lambda x: isinstance(x, np.ndarray))
    want_deq = jax.tree.map(lambda t: np.asarray(t[0]), want,
                            is_leaf=lambda x: isinstance(x, tuple))
    want_err = jax.tree.map(lambda t: np.asarray(t[1]), want,
                            is_leaf=lambda x: isinstance(x, tuple))
    assert _worst(_grads(model), want_deq) == 0.0
    assert _worst(reference_tree(model, err_t), want_err) == 0.0


def _ambiguous(records: list, window: float = 5e-4) -> dict:
    """Per parameter name, the elements whose pre-quantization value g /
    scale lay within ``window`` of a rounding boundary (a half-integer)
    at any step: there f32 noise between the packages may pick the other
    int8 code."""
    out = {}
    for step in records:
        for name, r in step.items():
            frac = np.abs(np.abs(r) % 1.0 - 0.5) <= window
            out[name] = out.get(name, np.zeros_like(frac)) | frac
    return out


@pytest.mark.parametrize("grad_compress,microbatches",
                         [(False, 1), (False, 2), (True, 1), (True, 2)])
def test_whole_train_steps_match_reference(grad_compress, microbatches,
                                           monkeypatch):
    """Three whole steps of both packages on reduced minicpm (B=4, S=16):
    the losses within 1e-5 relative and every parameter within 1e-5 of its
    leaf's max |p|.  At ``OptConfig(eps=1e-3)``: Adam's first step is
    mhat / (sqrt(nhat) + eps), about ±1 for any gradient far above eps,
    so at the default 1e-8 a gradient of ~1e-9 whose f32 sign differs
    between the packages moves a parameter by 2·lr; the update rule
    itself is held at the default eps on identical gradients above.
    With int8 compression an element whose g / scale lies at a rounding
    tie may take the neighbouring code in the other package; those
    elements (recorded at every step) are left out of the parameter
    check, and must be rare."""
    arch = "minicpm_2b"
    cfg, rcfg = _cfgs(arch)
    ocfg = dict(peak_lr=2e-3, warmup_steps=2, eps=1e-3)
    rstep = jax.jit(rTS.make_train_step(
        rcfg, rO.OptConfig(**ocfg), remat="full",
        grad_compress=grad_compress, microbatches=microbatches))
    rp = _weights(arch)
    ropt = rTS.init_opt_state(rp, grad_compress)
    model = _model(arch, trainable=False)
    topt = tTS.init_opt_state(model, grad_compress)
    tstep = tTS.make_train_step(cfg, tO.OptConfig(**ocfg), remat="full",
                                grad_compress=grad_compress,
                                microbatches=microbatches)
    records, real = [], tTS._compress_group

    def recording(gs, errs):
        g = [a.float() + e for a, e in zip(gs, errs)]
        scale = torch.stack([a.abs().max() for a in g]).max() / 127.0 + 1e-12
        records[-1].update({id(t): (a / scale).numpy()
                            for t, a in zip(gs, g)})
        return real(gs, errs)

    monkeypatch.setattr(tTS, "_compress_group", recording)
    for i in range(3):
        records.append({})
        toks = _batch(cfg, b=4, s=16, seed=20 + i)["tokens"]
        rp, ropt, rm = rstep(rp, ropt, {"tokens": jnp.asarray(toks)})
        model, topt, tm = tstep(model, topt,
                                {"tokens": torch.from_numpy(toks)})
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= 1e-5 * abs(
            float(rm["loss"]))
        # the compression's records by parameter name
        ids = {id(p.grad): n for n, p in model.named_parameters()}
        records[-1] = {ids[k]: v for k, v in records[-1].items()}
    assert model.embed.requires_grad
    got, want = _leaves(reference_tree(model)), _leaves(rp)
    skip = _ambiguous(records)
    assert bool(skip) == grad_compress
    # a uniform g / scale lies in the window at 2·5e-4 of the elements
    # per step: 0.3% over three steps
    n_skip = sum(int(m.sum()) for m in skip.values())
    assert n_skip <= 0.01 * sum(a.size for a in want.values())
    name_of = {path: leaf.names for path, leaf in leaf_groups(model).items()}
    for path, w in want.items():
        keep = np.ones(w.shape, bool)
        if skip:
            keep = ~np.stack([skip[n] for n in name_of[path]]).reshape(
                w.shape)
        err = np.abs(got[path] - w)[keep]
        assert err.max(initial=0.0) <= 1e-5 * np.abs(w).max(), path


def test_remat_modes_give_the_same_grads():
    """"none", "full" and "dots" differ only in what the backward pass
    recomputes."""
    for arch in ("minicpm_2b", "zamba2_2p7b", "whisper_medium"):
        cfg, _ = _cfgs(arch)
        batch = _torch(_batch(cfg))
        out = {}
        for remat in tT.REMAT:
            model = _model(arch)
            loss = tTS.next_token_loss(model, cfg, batch, remat)
            loss.backward()
            out[remat] = (loss.item(), _grads(model))
        for remat in ("full", "dots"):
            assert out[remat][0] == out["none"][0]
            assert _worst(out[remat][1], out["none"][1]) <= 1e-6, (arch,
                                                                   remat)
    with pytest.raises(ValueError, match="remat"):
        tT.forward(_model("minicpm_2b"), cfg, batch["tokens"], remat="some")


def test_dots_policy_saves_projections_only():
    """Under "dots" the backward recomputes the blocks' batched matmuls
    and elementwise ops but no projection: as many ``aten.mm`` calls as
    without remat, as many ``aten.bmm`` calls as "full"."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    cfg, _ = _cfgs("minicpm_2b")
    batch = _torch(_batch(cfg))
    seen = {}
    for remat in tT.REMAT:
        model = _model("minicpm_2b")
        loss = tTS.next_token_loss(model, cfg, batch, remat)
        with Count() as c:
            loss.backward()
        seen[remat] = c.n
    mm = torch.ops.aten.mm.default
    bmm = torch.ops.aten.bmm.default
    assert seen["dots"][mm] == seen["none"][mm] < seen["full"][mm]
    assert seen["dots"][bmm] == seen["full"][bmm] > seen["none"][bmm]


def test_microbatches_accumulate_as_one_batch():
    """The loss and the accumulated gradients (left in ``.grad`` by the
    step) of 2 and 4 microbatches equal one batch's; MoE capacity is per
    dispatch group, so at capacity factor 8, where nothing drops."""
    cfg, _ = _cfgs("deepseek_v2_236b")
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    batch = {"tokens": torch.from_numpy(_batch(cfg, b=4)["tokens"])}
    out = {}
    for mb in (1, 2, 4):
        model = _model("deepseek_v2_236b")
        step = tTS.make_train_step(cfg, tO.OptConfig(), microbatches=mb)
        _, _, m = step(model, tTS.init_opt_state(model), batch)
        out[mb] = (float(m["loss"]), _grads(model))
    for mb in (2, 4):
        assert abs(out[mb][0] - out[1][0]) <= 1e-5 * out[1][0]
        assert _worst(out[mb][1], out[1][1]) <= 1e-5
    with pytest.raises(ValueError, match="microbatches"):
        tTS.make_train_step(cfg, tO.OptConfig(), microbatches=3)(
            model, tTS.init_opt_state(model), batch)


def test_hybrid_loss_runs_the_chunked_scan(monkeypatch):
    """The SSD kernel has no backward (neither package's): the hybrid's
    loss asks for the chunked engine, on the CPU as on the card."""
    seen = []
    real = tT.forward

    def spy(*args, **kwargs):
        seen.append(kwargs.get("engine"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tT, "forward", spy)
    cfg, _ = _cfgs("zamba2_2p7b")
    tTS.next_token_loss(_model("zamba2_2p7b"), cfg, _torch(_batch(cfg)))
    assert seen == ["chunked"]


def test_ssd_kernel_refuses_grad_off_the_cpu():
    """The guard in ``ops.ssd_scan`` on a non-CPU tensor (the meta device
    stands in for the card: nothing is launched) that requires grad."""
    x = torch.empty(2, 128, 8, device="meta", requires_grad=True)
    ld = torch.empty(2, 128, device="meta")
    b = c = torch.empty(2, 128, 4, device="meta")
    with pytest.raises(RuntimeError, match="engine='chunked'"):
        ops.ssd_scan(x, ld, b, c)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD kernel runs only there")
    return torch.device("cuda", 0)


def test_ssd_kernel_raises_under_grad_on_the_card(cuda_device):
    cfg, _ = _cfgs("zamba2_2p7b")
    model = params_from_jax(_weights("zamba2_2p7b"), cfg,
                            device=cuda_device).requires_grad_(True)
    tokens = torch.from_numpy(_batch(cfg)["tokens"]).to(cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        tT.forward(model, cfg, tokens, engine="kernel")


def test_trained_model_serves_without_a_graph():
    """After a train step the parameters require grad; forward with
    caches refuses grad mode, and the serve steps build no graph."""
    arch = "minicpm_2b"
    cfg, _ = _cfgs(arch)
    model = _model(arch, trainable=False)
    step = tTS.make_train_step(cfg, tO.OptConfig())
    step(model, tTS.init_opt_state(model), _torch(_batch(cfg)))
    assert all(p.requires_grad for p in model.parameters())
    caches = tT.init_caches(cfg, 1, 8, device="cpu")
    tok = torch.zeros(1, 1, dtype=torch.long)
    with pytest.raises(RuntimeError, match="no_grad"):
        tT.forward(model, cfg, tok, caches=caches, cache_pos=0)
    last, caches = tS.prefill_step(model, cfg, tok, caches)
    logits, _ = tS.decode_step(model, cfg, tok, caches, 1)
    assert not last.requires_grad and not logits.requires_grad
