"""Mamba2 mixer (zamba2's backbone): SSD state-space recurrence (port of
``repro/models/mamba2.py``).

Three interchangeable scan engines (tests assert equivalence):
  * ``"chunked"`` — ``ssd_chunked_grouped``: the parallel chunked
    formulation in torch, all intra-chunk terms as batched matmuls plus a
    loop over chunk summaries.  The CPU default.
  * ``"kernel"`` — ``kernels.ops.ssd_scan(..., heads=nheads)``: the
    hand-written CUDA kernels on a CUDA tensor (the counterpart of the
    reference's ``"pallas"``), reading the head-shared B/C as they are;
    the exact recurrence on a CPU tensor.  The CUDA default.
  * ``"ref"`` — ``kernels.ref.ssd_scan_grouped_ref``: the exact sequential
    oracle (B/C expanded to every head).

Decode keeps an (nheads, N, P) state and a conv tail; one step is O(1) in
sequence length.

The widths come from the weights: under a mesh with a ``model`` extent
M > 1 (`models/shardings.py`, ``mamba_block``) ``p`` holds the rank's
nheads/M heads (its columns of z, x and dt in ``in_proj``, all of B and
C), the scan runs over those heads with B and C shared as everywhere,
the gated norm reads the whole d_inner through `shardings.tp_rmsnorm`,
and ``out_proj``'s row block is summed over ``model``.  The input enters
that split region through `shardings.tp_enter`, and so do the B/C
columns of ``in_proj`` and channels of ``conv_w``/``conv_b``, which
every rank holds whole but whose gradient each rank's heads give only
in part (`shardings.tp_enter_cols`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import pad_to
from repro_torch.models import shardings as SH
from repro_torch.models.layers import ParamTree, normal

ENGINES = ("chunked", "kernel", "ref")


def _decay_matrix(s: torch.Tensor) -> torch.Tensor:
    """L[..., t, u] = exp(s_t − s_u) for u ≤ t, else 0, masked BEFORE exp
    (no inf or overflow in the upper triangle)."""
    q = s.shape[-1]
    tri = torch.ones(q, q, dtype=torch.bool, device=s.device).tril()
    diff = (s[..., :, None] - s[..., None, :]).masked_fill(~tri, -math.inf)
    return torch.exp(diff)


def chunk_states(decay_c: torch.Tensor, summ: torch.Tensor) -> torch.Tensor:
    """State entering each chunk: h_prev[c] = Σ_{c' < c} (Π decays) S_c'.
    ``summ`` (..., NC, N, P); ``decay_c`` (..., NC, N|1, 1), each chunk's
    decay of the state's rows (one per head in Mamba2, one per channel in
    rwkv6) → (..., NC, N, P).  A loop over chunks in place of the
    reference's associative scan: linear in the chunk count, with no
    log-depth factor on the (N, P) states."""
    h = torch.zeros_like(summ[..., 0, :, :])
    prev = []
    for ci in range(summ.shape[-3]):
        prev.append(h)
        h = decay_c[..., ci, :, :] * h + summ[..., ci, :, :]
    return torch.stack(prev, -3)


def ssd_chunked_grouped(x, logdecay, b, c, chunk: int = 128):
    """Parallel SSD with head-shared B/C (Mamba2's single group): no
    (B, H, L, N) broadcast.

    x (B,H,L,P), logdecay (B,H,L), b/c (B,L,N) → (B,H,L,P).
    """
    bsz, h, l, p = x.shape
    n = b.shape[-1]
    x, logdecay = pad_to(x, 2, chunk), pad_to(logdecay, 2, chunk)
    b, c = pad_to(b, 1, chunk), pad_to(c, 1, chunk)
    lc = x.shape[2]
    nc = lc // chunk
    xr = x.reshape(bsz, h, nc, chunk, p)
    br = b.reshape(bsz, nc, chunk, n)
    cr = c.reshape(bsz, nc, chunk, n)
    s = torch.cumsum(logdecay.reshape(bsz, h, nc, chunk), -1)  # (B,H,NC,Q)
    lmat = _decay_matrix(s)                                    # (B,H,NC,Q,Q)
    cb = cr @ br.transpose(-1, -2)                 # (B,NC,Q,Q), all heads
    y_intra = (cb[:, None] * lmat) @ xr
    total = s[..., -1:]
    wlast = torch.exp(total - s)                               # (B,H,NC,Q)
    summ = br.transpose(-1, -2)[:, None] @ (wlast[..., None] * xr)
    h_prev = chunk_states(torch.exp(total)[..., None], summ)  # (B,H,NC,N,P)
    y_inter = (cr[:, None] @ h_prev) * torch.exp(s)[..., None]
    y = (y_intra + y_inter).reshape(bsz, h, lc, p)
    return y[:, :, :l]


def ssd_chunked(x, logdecay, b, c, chunk: int = 128):
    """Parallel SSD: x (BH,L,P), logdecay (BH,L), b/c (BH,L,N) → (BH,L,P)."""
    bh, l, p = x.shape
    n = b.shape[-1]
    x, logdecay = pad_to(x, 1, chunk), pad_to(logdecay, 1, chunk)
    b, c = pad_to(b, 1, chunk), pad_to(c, 1, chunk)
    lc = x.shape[1]
    nc = lc // chunk
    xr = x.reshape(bh, nc, chunk, p)
    br = b.reshape(bh, nc, chunk, n)
    cr = c.reshape(bh, nc, chunk, n)
    s = torch.cumsum(logdecay.reshape(bh, nc, chunk), -1)      # (BH,NC,Q)
    # intra-chunk: Y = ((C Bᵀ) ⊙ L) X
    y_intra = ((cr @ br.transpose(-1, -2)) * _decay_matrix(s)) @ xr
    # chunk summaries: S_c = Bᵀ diag(exp(s_Q − s)) X   (BH,NC,N,P)
    total = s[..., -1:]
    summ = br.transpose(-1, -2) @ (torch.exp(total - s)[..., None] * xr)
    h_prev = chunk_states(torch.exp(total)[..., None], summ)
    y_inter = (cr * torch.exp(s)[..., None]) @ h_prev
    y = (y_intra + y_inter).reshape(bh, lc, p)
    return y[:, :l]


def init_mamba2(gen: torch.Generator, cfg, dtype) -> dict:
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * n
    dev = gen.device
    return {
        "in_proj": normal(gen, (d, 2 * di + 2 * n + nh), 0.02, dtype),
        "conv_w": normal(gen, (cfg.ssm_conv, conv_dim), 0.2, dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "dt_bias": torch.zeros(nh, device=dev),
        "d_skip": torch.ones(nh, device=dev),
        "gate_gamma": torch.zeros(di, dtype=dtype, device=dev),
        "out_proj": normal(gen, (di, d), 0.02, dtype),
    }


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv of width K as K shifted sums.  xbc: (B,L,C),
    w: (K,C).  state: (B, K-1, C) tail of previous tokens (decode);
    returns (y, tail)."""
    k = w.shape[0]
    pad = xbc.new_zeros(xbc.shape[0], k - 1, xbc.shape[2]) \
        if state is None else state
    full = torch.cat([pad, xbc], 1)
    y = sum(full[:, i:i + xbc.shape[1]] * w[i] for i in range(k))
    tail = full[:, -(k - 1):]
    return F.silu(y + b), tail


def scan_inputs(p, x, cfg, conv_state=None):
    """The mixer up to its scan: x (B,L,d) → (z, xh (B,L,nh,hd), x_eff
    = xh·dt in f32, logdecay (B,L,nh), bmat, cmat (B,L,N), conv_tail);
    nh the heads ``p`` holds (`heads`)."""
    b_sz, l, _ = x.shape
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    nh = heads(p)
    di = nh * hd
    zxbcdt = SH.tp_enter(x) @ SH.tp_enter_cols(p.in_proj, 2 * di,
                                               2 * di + 2 * n)
    z, xbc, dt = zxbcdt.split([di, di + 2 * n, nh], -1)
    xbc, conv_tail = _causal_conv(xbc, SH.tp_enter_cols(p.conv_w, di,
                                                        di + 2 * n),
                                  SH.tp_enter_cols(p.conv_b, di, di + 2 * n),
                                  conv_state)
    xs, bmat, cmat = xbc.split([di, n, n], -1)
    dt = F.softplus(dt.float() + p.dt_bias)                    # (B,L,nh)
    logdecay = -torch.exp(p.a_log) * dt                        # (B,L,nh)
    xh = xs.reshape(b_sz, l, nh, hd)
    return z, xh, xh.float() * dt[..., None], logdecay, bmat, cmat, \
        conv_tail


def heads(p) -> int:
    """The SSM heads whose parameters ``p`` holds (all of them, or a
    rank's under a mesh)."""
    return p.a_log.shape[0]


def merge_heads(x_eff, logdecay, bmat, cmat):
    """The scan's grouped (BH, ·) layout of the kernel and oracle engines:
    batch and heads merged, the heads of one batch row consecutive, and B/C
    left un-broadcast — every head of a batch row shares its (L, N) row
    (``ops.ssd_scan(..., heads=nh)``), so no (BH, L, N) copy is made.
    x_eff (B,L,nh,hd), logdecay (B,L,nh), bmat/cmat (B,L,N) → x (BH,L,hd),
    logdecay (BH,L), b/c (B,L,N), all contiguous f32."""
    b_sz, l, nh, hd = x_eff.shape
    xe = x_eff.permute(0, 2, 1, 3).reshape(b_sz * nh, l, hd)
    ld = logdecay.permute(0, 2, 1).reshape(b_sz * nh, l)
    return (xe.contiguous(), ld.contiguous(), bmat.float().contiguous(),
            cmat.float().contiguous())


def mamba2_mixer(p, x, cfg, state=None, engine: Optional[str] = None):
    """x: (B,L,d) → (B,L,d).  ``p`` holds the reference's ``mamba`` keys
    (a `ParamTree` or `Mamba2`, or their gathered view).  state:
    dict(ssm=(B,nh,N,P), conv=(B,K-1,C)) for one decode step (L == 1);
    returns (y, new_state).

    ``engine=None`` is ``"kernel"`` on a CUDA tensor and ``"chunked"`` on
    the CPU.  A state with L != 1 raises: one step's recurrence cannot
    stand for L steps (the reference reads step 0 and broadcasts it).
    """
    b_sz, l, _ = x.shape
    nh, hd = heads(p), cfg.ssm_head_dim
    di = nh * hd
    if state is not None and l != 1:
        raise ValueError(f"mamba2_mixer with a state takes one step, got "
                         f"L={l}; run the full sequence without a state")
    z, xh, x_eff, logdecay, bmat, cmat, conv_tail = scan_inputs(
        p, x, cfg, None if state is None else state["conv"])
    if state is None:
        if engine is None:
            engine = "kernel" if x.is_cuda else "chunked"
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got "
                             f"{engine!r}")
        if engine == "chunked":
            y = ssd_chunked_grouped(x_eff.permute(0, 2, 1, 3),  # (B,H,L,P)
                                    logdecay.permute(0, 2, 1),  # (B,H,L)
                                    bmat.float(), cmat.float())
        else:
            scan = (ops.ssd_scan if engine == "kernel"
                    else ref.ssd_scan_grouped_ref)
            y = scan(*merge_heads(x_eff, logdecay, bmat, cmat), heads=nh)
            y = y.reshape(b_sz, nh, l, hd)
        y = y.permute(0, 2, 1, 3)
        new_state = None
    else:
        # single-step recurrence: h = e^{a·dt} h + dt·B xᵀ ; y = C h
        h = state["ssm"]                                       # (B,nh,N,P)
        dec = torch.exp(logdecay[:, 0])                        # (B,nh)
        upd = bmat[:, 0].float()[:, None, :, None] * x_eff[:, 0, :, None, :]
        h = dec[..., None, None] * h + upd
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(), h)
        y = y.reshape(b_sz, 1, nh, hd)
        new_state = {"ssm": h, "conv": conv_tail}
    y = y + p.d_skip[None, None, :, None] * xh.float()
    y = y.reshape(b_sz, l, di)
    y = SH.tp_rmsnorm(y.to(x.dtype) * F.silu(z), p.gate_gamma, cfg.norm_eps)
    return SH.tp_psum(y @ p.out_proj), new_state


class Mamba2(ParamTree):
    """One Mamba2 mixer's parameters (the reference's ``mamba`` dict) as a
    module; ``forward`` is `mamba2_mixer`."""

    def __init__(self, cfg, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, x, state=None, engine: Optional[str] = None):
        return mamba2_mixer(self, x, self.cfg, state=state, engine=engine)


def init_mamba2_state(cfg, batch: int, dtype=torch.float32, device=None,
                      model: int = 1):
    """One layer's decode state: ``ssm`` (B, nh, N, P) in f32 and the conv
    tail (B, K−1, di + 2N); with ``model`` = M > 1 a rank's, over its
    nh/M heads and di/M + 2N channels."""
    return {
        "ssm": torch.zeros(batch, cfg.ssm_nheads // model, cfg.ssm_state,
                           cfg.ssm_head_dim, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv - 1,
                            cfg.d_inner // model + 2 * cfg.ssm_state,
                            dtype=dtype, device=device),
    }
