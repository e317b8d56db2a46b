"""RWKV6 "Finch" mixer (attention-free, data-dependent decay;
arXiv:2404.05892), port of ``repro/models/rwkv6.py``: plain functions on
tensors.

Time mix:  S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ,
           y_t = r_t·(S_{t-1} + diag(u)·k_t v_tᵀ),
with per-channel decay w_t = exp(−exp(w₀ + tanh(x W₁) W₂)).  The
full-sequence path evaluates it in chunks of 16: intra-chunk pairwise terms
as batched matmuls, the state between chunks carried by a loop over chunk
summaries (``mamba2.chunk_states``, as the port's Mamba2 does; the
reference uses an associative scan), so its cost is linear in L.

Decode carries a (B, H, N, P) state and the previous token of each mix:
O(1) per token, no KV cache.  A call with a state takes exactly one token
and raises otherwise: the reference's stateful step reads only token 0's
r, k, v and broadcasts one output row (and the channel mix's previous
token) over all L positions, which is wrong for L > 1, so the port's
``prefill_step`` runs rwkv6 prompts token by token.

Under a mesh with a ``model`` extent M > 1 (`models/shardings.py`) the
widths come from the weights: the time mix holds the rank's H/M heads
(column blocks of wr, wk, wv, wg; its channels of w0, w2, u and
ln_gamma; rows of wo), runs the WKV on them, norms over all of d with
`shardings.tp_rmsnorm` and sums its output over ``model``; the channel
mix holds column blocks of wr and wk and a row block of wv, sums the
value product over ``model`` and gathers the receptance.  Both mixes
read the whole (replicated) normed input, so ``prev``/``prev_cm`` stay
whole and only ``wkv`` is per head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import pad_to
from repro_torch.models import shardings as SH
from repro_torch.models.layers import normal
from repro_torch.models.mamba2 import chunk_states

LORA = 64              # rank of the decay's data-dependent term
LOGW_MIN = -4.0        # decay clip: keeps exp(±chunk·|logw|) inside f32


def init_rwkv6(gen: torch.Generator, cfg, dtype) -> dict:
    """The time mix's weights; ``w0`` and ``u`` are f32 whatever
    ``dtype``."""
    d = cfg.d_model
    dev = gen.device

    def half():
        return torch.full((d,), 0.5, dtype=dtype, device=dev)

    return {
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
        "mu_g": half(),
        "wr": normal(gen, (d, d), 0.02, dtype),
        "wk": normal(gen, (d, d), 0.02, dtype),
        "wv": normal(gen, (d, d), 0.02, dtype),
        "wg": normal(gen, (d, d), 0.02, dtype),
        "wo": normal(gen, (d, d), 0.02, dtype),
        "w0": torch.full((d,), -2.0, dtype=torch.float32, device=dev),
        "w1": normal(gen, (d, LORA), 0.02, dtype),
        "w2": normal(gen, (LORA, d), 0.02, dtype),
        "u": normal(gen, (d,), 0.5, torch.float32),
        "ln_gamma": torch.zeros((d,), dtype=dtype, device=dev),
    }


def init_rwkv6_channel_mix(gen: torch.Generator, cfg, dtype) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    dev = gen.device
    return {
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "wr": normal(gen, (d, d), 0.02, dtype),
        "wk": normal(gen, (d, dff), 0.02, dtype),
        "wv": normal(gen, (dff, d), 0.02, dtype),
    }


def _wkv_chunked(r, k, v, logw, u, head_dim: int, chunk: int = 16):
    """r, k, v, logw: (B, L, d) f32; u: (d,).  The per-head linear
    recurrence over the whole sequence from a zero state → (B, L, d).

    The decay exp(s_{t-1} − s_j) between steps j < t factorises over the
    channel contraction: A[t, j] = Σ_n (r⊙e^{s_shift})[t, n]·(k⊙e^{−s})[j, n]
    is one matmul per chunk, with no (Q, Q, N) cube.  Cumsums are
    chunk-relative and logw ≥ LOGW_MIN, so neither factor overflows f32
    (chunk·|LOGW_MIN| = 64)."""
    b, l, d = r.shape
    h = d // head_dim
    r, k, v, logw = (pad_to(a, 1, chunk) for a in (r, k, v, logw))
    nc = r.shape[1] // chunk

    def split(a):     # (B, L, d) -> (B, H, NC, Q, hd)
        return a.reshape(b, nc, chunk, h, head_dim).permute(0, 3, 1, 2, 4)

    rr, kk, vv, ww = split(r), split(k), split(v), split(logw)
    uu = u.reshape(h, head_dim)[None, :, None, None, :]
    s = ww.cumsum(-2)                                   # chunk-relative
    # contribution of step j < t: (r_t ⊙ Π_{i=j+1..t-1} w_i ⊙ k_j) · v_j,
    # Π_{j+1..t-1} = exp(s_{t-1} − s_j): the shifted cumsum, factorised
    s_shift = F.pad(s, (0, 0, 1, 0))[..., :-1, :]       # s_{t-1}
    r_dec = rr * torch.exp(s_shift)
    amat = (r_dec @ (kk * torch.exp(-s)).transpose(-1, -2)).tril(-1)
    y = amat @ vv
    # current-token bonus: (Σ_n r_t·u·k_t) · v_t
    y = y + (rr * uu * kk).sum(-1, keepdim=True) * vv
    # chunk summaries ΔS_c = Σ_j exp(s_Q − s_j) k_j v_jᵀ, decay_c = exp(s_Q)
    total = s[..., -1:, :]                              # (B, H, NC, 1, hd)
    summ = (kk * torch.exp(total - s)).transpose(-1, -2) @ vv
    h_prev = chunk_states(torch.exp(total).transpose(-1, -2), summ)
    y = y + r_dec @ h_prev
    return y.permute(0, 2, 3, 1, 4).reshape(b, nc * chunk, d)[:, :l]


def _shifted(x, prev, what: str):
    """The previous token of each position: zeros then x[:, :-1] without a
    state, the state's token with one (exactly one step)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    if x.shape[1] != 1:
        raise ValueError(f"{what} with a state takes one step, got "
                         f"L={x.shape[1]}; run the full sequence without a "
                         f"state")
    return prev[:, None, :].to(x.dtype)


def rwkv6_time_mix(p, x, cfg, state=None):
    """x: (B, L, d), the normed block input.  ``p`` holds the reference's
    ``tmix`` keys.  state: dict(prev=(B, d), wkv=(B, H, N, P)) for one
    decode step (L == 1); returns (y, new_state), new_state None without
    a state.  The new ``prev`` is the step's (normed) input."""
    b = x.shape[0]
    hd = cfg.ssm_head_dim
    xs = _shifted(x, None if state is None else state["prev"],
                  "rwkv6_time_mix")
    dx = xs - x

    def mix(mu):
        return x + dx * mu

    r = mix(p.mu_r) @ p.wr
    k = mix(p.mu_k) @ p.wk
    v = mix(p.mu_v) @ p.wv
    g = F.silu(mix(p.mu_g) @ p.wg)
    logw = -torch.exp(p.w0 + (torch.tanh(mix(p.mu_w) @ p.w1).float()
                              @ p.w2.float()))       # (B, L, d), negative
    d = r.shape[-1]                                  # the rank's channels
    logw = logw.clamp(LOGW_MIN, -1e-4)
    if state is None:
        y = _wkv_chunked(r.float(), k.float(), v.float(), logw, p.u, hd)
        new_state = None
    else:
        h = d // hd
        rr, kk, vv = (t[:, 0].float().reshape(b, h, hd) for t in (r, k, v))
        ww = torch.exp(logw[:, 0]).reshape(b, h, hd)
        uu = p.u.reshape(h, hd)
        wkv = state["wkv"]                               # (B, H, N, P)
        kv = kk[..., :, None] * vv[..., None, :]
        y = torch.einsum("bhn,bhnp->bhp", rr, wkv + uu[None, :, :, None] * kv)
        y = y.reshape(b, 1, d)
        new_state = {"prev": x[:, 0].float(),
                     "wkv": ww[..., None] * wkv + kv}
    y = SH.tp_rmsnorm(y.to(x.dtype), p.ln_gamma, cfg.norm_eps) * g
    return SH.tp_psum(y @ p.wo), new_state


def rwkv6_channel_mix(p, x, state=None):
    """x: (B, L, d), the normed input.  state: the previous token (B, d)
    for one decode step (L == 1); returns (y, new_state), new_state None
    without a state."""
    xs = _shifted(x, state, "rwkv6_channel_mix")
    dx = xs - x
    r = SH.tp_gather(torch.sigmoid((x + dx * p.mu_r) @ p.wr), -1)
    hid = torch.square(torch.relu((x + dx * p.mu_k) @ p.wk))
    return r * SH.tp_psum(hid @ p.wv), \
        (None if state is None else x[:, 0].float())


def init_rwkv6_state(cfg, batch: int, device=None, model: int = 1) -> dict:
    """One layer's decode state, all f32: ``prev`` and ``prev_cm``
    (B, d), ``wkv`` (B, H, N, P); with ``model`` = M > 1 a rank's, its
    H/M heads of ``wkv``."""
    h = cfg.d_model // cfg.ssm_head_dim // model
    hd = cfg.ssm_head_dim
    return {
        "prev": torch.zeros(batch, cfg.d_model, device=device),
        "wkv": torch.zeros(batch, h, hd, hd, device=device),
        "prev_cm": torch.zeros(batch, cfg.d_model, device=device),
    }
