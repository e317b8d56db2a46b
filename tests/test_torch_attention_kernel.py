"""The fused attention forward (``ops.attention_fwd``): the dispatch rule
of ``models/attention.attention`` as a predicate over the inputs, the
plain version (``ref.attention_ref``, the op on a CPU tensor) against the
model's composed path (``composed``, ``_sdpa`` and ``_sdpa_online``) at
every edge the kernel handles, the counters, the wrapper's contract, and,
on the card only, the CUDA kernel against the composed path at the
benchmark cells' shapes and at the edges (the kernel has no CPU mode)."""
import dataclasses

import pytest
import torch
import torch.utils.checkpoint as ckpt

from repro_torch.configs.base import get_config
from repro_torch.kernels import attention as tatt
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tA
from repro_torch.models import transformer as tT
from repro_torch.obs import metrics

TOL = 1e-5        # of max |reference|: another summation order in f32


def _qkv(b, sq, skv, h, kvh, hd, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, h, hd, generator=g)
    k = torch.randn(b, skv, kvh, hd, generator=g)
    v = torch.randn(b, skv, kvh, hd, generator=g)
    return tuple(t.to(device) for t in (q, k, v))


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


# -- the dispatch rule -------------------------------------------------------

def _takes(q, k, v, cursor=None, merged=False):
    return tA.kernel_takes(q, k, v, cursor, merged)


@pytest.mark.parametrize("case,want", [
    ("f32", True), ("hd80", True), ("hd128", True), ("int_cursor", True),
    ("one_tile", True), ("no_grad_mode", True), ("grad", False),
    ("tensor_cursor", False), ("merged", False), ("hd256", False),
    ("bf16", False), ("one_token", False), ("short", False)])
def test_dispatch_rule(case, want):
    hd = {"hd80": 80, "hd128": 128, "hd256": 256}.get(case, 64)
    sq = {"one_token": 1, "short": tatt.Q_TILE - 1,
          "one_tile": tatt.Q_TILE}.get(case, 96)
    q, k, v = _qkv(1, sq, 128, 2, 2, hd)
    if case == "bf16":
        q, k, v = (t.bfloat16() for t in (q, k, v))
    cursor = {"int_cursor": 32,
              "tensor_cursor": torch.tensor([32])}.get(case)
    if case in ("grad", "no_grad_mode"):
        q.requires_grad_(True)
    if case == "no_grad_mode":
        with torch.no_grad():
            assert _takes(q, k, v, cursor) is want
        return
    assert _takes(q, k, v, cursor, merged=case == "merged") is want


def test_dispatch_keeps_remat_recompute_on_composed_path():
    """Training's remat (``use_reentrant=False``) recomputes the block
    under grad mode with q requiring a gradient: neither the forward nor
    the recomputation takes the kernel."""
    seen = []
    x = torch.randn(1, 96, 32, requires_grad=True)
    w = torch.randn(32, 64)

    def body(x):
        q = (x @ w).reshape(1, 96, 1, 64)
        seen.append(_takes(q, q, q))
        return (q * q).sum()       # saves q: the backward recomputes it

    ckpt.checkpoint(body, x, use_reentrant=False).backward()
    assert seen == [False, False]


def test_attention_counts_nothing_on_cpu():
    """On the CPU every call takes the composed path, which has no kernel
    to miss there: neither counter moves (a counter that ticks on every
    CPU forward would allocate in ``obs`` once it passes Python's cached
    small ints; see ``test_torch_obs_spans``)."""
    cfg = get_config("minicpm_2b").reduced()
    model = tT.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 64))
    before = metrics.get(tA.COMPOSED), metrics.get(tatt.LAUNCHES)
    with torch.no_grad():
        tT.forward(model, cfg, tokens)
    assert metrics.get(tA.COMPOSED) == before[0]
    assert metrics.get(tatt.LAUNCHES) == before[1]


# -- the plain version against the model's composed path ----------------------

# (b, sq, skv, h, kvh, hd, q_offset, window, causal, cap)
EDGES = {
    "causal": (2, 96, 96, 4, 4, 64, 0, None, True, None),
    "gqa_rep4": (2, 80, 80, 8, 2, 64, 0, None, True, None),
    "window128": (1, 300, 300, 2, 2, 64, 0, 128, True, None),
    "softcap50": (2, 70, 70, 2, 2, 80, 0, None, True, 50.0),
    "non_causal": (2, 64, 150, 2, 2, 64, 0, None, False, None),
    "offset_prefill": (2, 100, 256, 2, 1, 64, 40, None, True, None),
    "ragged_tile": (1, 130, 130, 3, 3, 80, 0, None, True, None),
    "no_key_prefix": (1, 70, 70, 2, 2, 64, -5, None, True, None),
    "no_key_window": (1, 64, 100, 2, 2, 64, 150, 16, True, None),
    "hd128": (1, 72, 72, 2, 2, 128, 0, 32, True, 30.0),
}


def _mask(sq, skv, q_offset, window, causal):
    qpos = torch.arange(sq)[:, None] + q_offset
    key = torch.arange(skv)[None, :]
    keep = key <= qpos if causal else torch.ones(sq, skv, dtype=torch.bool)
    if window is not None:
        keep = keep & (key > qpos - window)
    return keep


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_plain_version_matches_sdpa_and_online(edge):
    b, sq, skv, h, kvh, hd, off, window, causal, cap = EDGES[edge]
    q, k, v = _qkv(b, sq, skv, h, kvh, hd, seed=sq + skv)
    scale = hd ** -0.5
    got = tops.attention_fwd(q, k, v, scale=scale, q_offset=off,
                             window=window, is_causal=causal, cap=cap)
    dense = tA._sdpa(q, k, v, _mask(sq, skv, off, window, causal), cap,
                     scale)
    online = tA._sdpa_online(q, k, v, cap, scale, q_offset=off,
                             window=window, is_causal=causal)
    model = tA.composed(q, k, v, scale=scale, q_offset=off, window=window,
                        is_causal=causal, cap=cap)
    assert got.shape == (b, sq, h, hd) and got.dtype == torch.float32
    assert _rel(got, dense) <= TOL
    assert _rel(got, model) <= TOL
    assert _rel(online, dense) <= 1e-4
    if edge.startswith("no_key"):
        # a row with no key left averages every value, as softmax over
        # -1e30 everywhere gives it
        row = 0 if edge == "no_key_prefix" else sq - 1
        mean = v.mean(1).repeat_interleave(h // kvh, 1)
        assert _rel(got[:, row], mean) <= TOL


def test_composed_above_threshold_is_online(monkeypatch):
    """Above ONLINE_THRESHOLD² the composed path is ``_sdpa_online``, and
    the plain version agrees with it."""
    monkeypatch.setattr(tA, "ONLINE_THRESHOLD", 32)
    monkeypatch.setattr(tA, "KV_BLOCK", 16)
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, seed=3)
    got = tA.composed(q, k, v, scale=0.125, window=20)
    want = tA._sdpa_online(q, k, v, None, 0.125, q_offset=0, window=20)
    assert torch.equal(got, want)
    plain = tops.attention_fwd(q, k, v, scale=0.125, window=20)
    assert _rel(plain, want) <= TOL


# -- the wrapper's contract ---------------------------------------------------

def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = _qkv(1, 64, 64, 2, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.attention_cuda(q, k, v, scale=0.125)


def test_readable_strides():
    q, _, _ = _qkv(1, 64, 64, 4, 4, 64)
    assert tatt.readable(q)
    assert tatt.readable(q.transpose(1, 2))      # any multiple-of-4 strides
    assert not tatt.readable(q[..., 1:61])       # start off 16 bytes
    assert not tatt.readable(q.transpose(2, 3))  # hd not unit-stride


def test_kernel_source_and_shared_memory_budget():
    src = tatt.SOURCE.read_text()
    assert 'extern "C" int attn_fwd_launch(' in src
    assert "sm_90a" in " ".join(tatt._build.NVCC_FLAGS)
    assert "use_fast_math" not in " ".join(tatt._build.NVCC_FLAGS)
    # three blocks per SM at hd 64, two at 80, one at 128
    got = {hd: tatt.smem_bytes(hd) for hd in tatt.HEAD_DIMS}
    assert got == {64: 69632, 80: 82176, 128: 119808}
    assert 3 * got[64] + 3 * 1024 <= 233472
    assert 2 * got[80] + 2 * 1024 <= 233472


# -- the kernel, on the card only ---------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_gap(dev, b, sq, skv, h, kvh, hd, off, window, causal, cap,
              chunk=None):
    q, k, v = _qkv(b, sq, skv, h, kvh, hd, seed=b + sq + h, device=dev)
    scale = hd ** -0.5
    before = metrics.get(tatt.LAUNCHES)
    got = tops.attention_fwd(q, k, v, scale=scale, q_offset=off,
                             window=window, is_causal=causal, cap=cap)
    assert metrics.get(tatt.LAUNCHES) == before + 1
    chunk = chunk or b
    gap = 0.0
    for lo in range(0, b, chunk):
        sl = slice(lo, lo + chunk)
        want = tA.composed(q[sl], k[sl], v[sl], scale=scale, q_offset=off,
                           window=window, is_causal=causal, cap=cap)
        gap = max(gap, _rel(got[sl], want))
        del want
    torch.cuda.synchronize()
    return gap


@pytest.mark.parametrize("shape", ["minicpm", "hybrid"])
def test_cuda_kernel_at_cell_shapes(cuda_device, shape):
    """minicpm-2B's scoring call (24 × 2048, 36 heads of 64) and the
    hybrid's shared block (32 × 2048, 32 heads of 80), against the
    composed path in batch chunks (its logits fit beside the inputs)."""
    b, h, hd = {"minicpm": (24, 36, 64), "hybrid": (32, 32, 80)}[shape]
    assert _card_gap(cuda_device, b, 2048, 2048, h, h, hd, 0, None, True,
                     None, chunk=4) <= TOL


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_cuda_kernel_at_edges(cuda_device, edge):
    assert _card_gap(cuda_device, *EDGES[edge]) <= TOL


def test_cuda_kernel_refuses_gradients(cuda_device):
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, device=cuda_device)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.attention_fwd(q, k, v, scale=0.125)


def test_cuda_attention_dispatch(cuda_device):
    """minicpm reduced to 4 layers of 4 heads of 64: a forward without
    gradient launches the kernel once per layer, one with gradients takes
    the composed path in every layer, and their logits agree."""
    cfg = get_config("minicpm_2b").reduced()
    cfg = dataclasses.replace(cfg, d_model=256)           # 4 heads of 64
    model = tT.init_params(cfg, 0, device=cuda_device)
    tokens = torch.randint(0, cfg.vocab, (2, 128), device=cuda_device)
    launches, composed = metrics.get(tatt.LAUNCHES), metrics.get(tA.COMPOSED)
    with torch.no_grad():
        fused = tT.forward(model, cfg, tokens)[0]
    assert metrics.get(tatt.LAUNCHES) - launches == cfg.n_layers
    assert metrics.get(tA.COMPOSED) == composed
    with torch.enable_grad():
        for prm in model.parameters():
            prm.requires_grad_(True)
        plain = tT.forward(model, cfg, tokens)[0].detach()
    assert metrics.get(tA.COMPOSED) - composed == cfg.n_layers
    assert _rel(fused, plain) <= 1e-4


# every family whose forward calls `attention`, widened to heads of 64:
# the forward kwargs besides the tokens
FAMILIES = {"minicpm_2b": {}, "gemma2_9b": {}, "internvl2_26b": {"prefix": 8},
            "zamba2_2p7b": {}, "whisper_medium": {"frames": 96}}


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_cuda_families_fused_against_composed(cuda_device, arch):
    """Each family's forward without gradient (the kernel in every
    attention call: gemma2's windows and softcap, internvl2's prefix and
    GQA, the hybrid's shared block, whisper's non-causal encoder and
    cross-attention) against its forward with gradients (the composed
    path in every call); and, where the caches are indexed by position,
    ``prefill_step`` at cursor 0 (the kernel with Skv = max_len > Sq)."""
    from repro_torch.serve import serve_step as tS
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(
        cfg, d_model=cfg.n_heads * 64,
        head_dim=None if cfg.head_dim is None else 64)
    assert cfg.hd == 64
    model = tT.init_params(cfg, 0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, s = 2, 96
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g,
                           device=cuda_device)
    kw = {}
    if "prefix" in FAMILIES[arch]:
        kw["prefix_embeds"] = torch.randn(
            (b, FAMILIES[arch]["prefix"], cfg.d_model), generator=g,
            device=cuda_device)
    if "frames" in FAMILIES[arch]:
        kw["enc_frames"] = torch.randn(
            (b, FAMILIES[arch]["frames"], cfg.d_model), generator=g,
            device=cuda_device)
    if cfg.family == "hybrid":
        kw["engine"] = "chunked"     # the scan the gradient path runs
    launches, composed = metrics.get(tatt.LAUNCHES), metrics.get(tA.COMPOSED)
    with torch.no_grad():
        fused = tT.forward(model, cfg, tokens, **kw)[0]
        if cfg.family in ("dense", "vlm"):
            caches = tT.init_caches(cfg, b, s + 64 + kw.get(
                "prefix_embeds", tokens[:, :0, None]).shape[1],
                device=cuda_device)
            kw_p = {k: v for k, v in kw.items() if k == "prefix_embeds"}
            last = tS.prefill_step(model, cfg, tokens, caches, **kw_p)[0]
    assert metrics.get(tatt.LAUNCHES) > launches
    assert metrics.get(tA.COMPOSED) == composed
    for prm in model.parameters():
        prm.requires_grad_(True)
    plain = tT.forward(model, cfg, tokens, **kw)[0].detach()
    assert metrics.get(tA.COMPOSED) > composed
    assert _rel(fused, plain) <= 1e-4
    if cfg.family in ("dense", "vlm"):
        assert _rel(last, plain[:, -1]) <= 1e-4
