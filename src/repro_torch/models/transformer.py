"""The decoder assembler (port of ``repro/models/transformer.py``):

  dense   — pre-norm GQA + SwiGLU (minicpm, mistral-large), or a 2-matrix
            GELU MLP (starcoder2); gemma2 adds alternating local/global
            windows, logit softcaps and post-norms
  vlm     — internvl2: the dense decoder after stub patch embeddings
            (``prefix_embeds``)
  moe     — llama4-scout (top-1 + shared), deepseek-v2 (MLA + 2 shared +
            160 routed top-6)
  hybrid  — zamba2: a Mamba2 stack with ONE weight-shared attention+MLP
            block applied after every `attn_every` Mamba layers (its KV
            caches are per *application*)
  ssm     — rwkv6: per layer the time mix and the channel mix
            (``models/rwkv6.py``); the decode state (``prev``, ``wkv``,
            ``prev_cm``) does not grow with position
  audio   — whisper: a non-causal encoder over stub frame embeddings
            (``enc_frames``), and decoder blocks with cross-attention to
            its output, whose K/V are cached (``xk``/``xv``) at prefill

Under a mesh (``shardings.use_mesh``) whose ``model`` extent M > 1, every
family runs tensor-parallel, Megatron-style: each rank holds the blocks
that `shardings.tp_block` gives it (attention and MLA heads, FFN hidden
and the shared expert in column / row blocks, its experts, its Mamba2
and rwkv6 heads, its vocab rows), sums each row-parallel product over
``model``, norms a split width over ``model`` (`shardings.tp_rmsnorm`),
looks up only its vocab rows of the embedding, and gathers the logits'
vocab slices; the residual stream, and whisper's encoder output, are
whole on every rank, and the caller passes the rank's rows of the batch.
Every replicated tensor entering a split region passes `shardings.
tp_enter`, so the backward gives every leaf its whole gradient: training
runs at any M that `shardings.check_tp` admits.  Over the data axes
(extent D > 1) each rank holds its FSDP shard of every leaf the spec
shards there (`shardings.rank_block`), and each block gathers its
weights at its start (`shardings.gathered`) inside the function that
``remat`` checkpoints; a batch that the data axes do not divide is whole
on every data rank, with the attention caches' sequence split over
``data`` (`init_caches`, `shardings.SeqSplitCaches`).  With no mesh, or
M = D = 1, nothing changes.  ``remat`` recomputes
each decoder block, Mamba layer and encoder block in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does,
the FSDP gathers included.

``forward`` runs with caches updated in place (the reference returns new
caches; here the returned dict is the one passed in).  Its grad mode
follows the caller's: parameters are frozen unless a trainer turns them
on (``train/train_step.py``), and caches are refused while a parameter
requires a gradient.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core.mesh import device_of
from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M2
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.models import shardings as SH
from repro_torch.models.layers import (ParamTree, gelu_mlp, normal, rmsnorm,
                                       softcap, swiglu, whole)


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family == "hybrid" and cfg.n_layers % cfg.attn_every:
        raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of "
                         f"attn_every={cfg.attn_every}")


#: ``remat`` values: keep every activation, recompute the whole block, or
#: keep only the outputs of matmuls without a batch dimension
REMAT = ("none", "full", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``: the mirror of
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``.  A
    projection ``x @ W`` reaches ``aten.mm``; the batched matmuls of the
    attention scores and the expert stacks (``aten.bmm``) have a batch
    dimension, so they are recomputed as in the reference."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, x: torch.Tensor, remat: str) -> torch.Tensor:
    """``fn(x)``, one block; under grad mode with ``remat`` "full" or
    "dots" its activations are recomputed in the backward pass."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn(x)
    kw = ({} if remat == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_dots)})
    return ckpt.checkpoint(fn, x, use_reentrant=False, **kw)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _init_mlp(gen: torch.Generator, cfg, dtype, keep=whole) -> dict:
    d, f = cfg.d_model, cfg.d_ff

    def draw(name, shape):
        return keep(f"mlp.{name}", normal(gen, shape, 0.02, dtype))

    if cfg.mlp_gelu:            # starcoder2: 2-matrix GELU MLP
        return {"w_up": draw("w_up", (d, f)),
                "w_down": draw("w_down", (f, d))}
    return {"w_gate": draw("w_gate", (d, f)), "w_up": draw("w_up", (d, f)),
            "w_down": draw("w_down", (f, d))}


def _mlp(p, x, cfg):
    """The MLP; under a mesh ``p`` holds column blocks of w_gate/w_up and a
    row block of w_down, whose partial product is summed over model."""
    x = SH.tp_enter(x)
    if cfg.mlp_gelu:
        return SH.tp_psum(gelu_mlp(x, p.w_up, p.w_down))
    return SH.tp_psum(swiglu(x, p.w_gate, p.w_up, p.w_down))


def _kept(keep, prefix: str, tree: dict) -> dict:
    """Each leaf of a freshly drawn ``tree`` through ``keep``, named
    ``prefix.<key>`` (the transient memory is the one sub-tree)."""
    return {k: keep(f"{prefix}.{k}", v) for k, v in tree.items()}


def _init_block(gen: torch.Generator, cfg, dtype, zeros,
                cross: bool = False, keep=whole) -> dict:
    d = cfg.d_model
    p = {"ln1": zeros(d)}
    if cfg.family == "ssm":
        p["tmix"] = _kept(keep, "tmix", R6.init_rwkv6(gen, cfg, dtype))
        p["ln2"] = zeros(d)
        p["cmix"] = _kept(keep, "cmix",
                          R6.init_rwkv6_channel_mix(gen, cfg, dtype))
        return p
    p["attn"] = (_kept(keep, "attn", MLA.init_mla(gen, cfg, dtype))
                 if cfg.is_mla else A.init_attn(gen, cfg, dtype, keep))
    p["ln2"] = zeros(d)
    if cfg.is_moe:
        p["moe"] = MOE.init_moe(gen, cfg, dtype, keep)
    else:
        p["mlp"] = _init_mlp(gen, cfg, dtype, keep)
    if cross:                           # whisper's decoder blocks
        p["ln_x"] = zeros(d)
        p["xattn"] = A.init_attn(gen, cfg, dtype, keep)
    if cfg.local_global_alternate:      # gemma2 post-norms
        p["post1"] = zeros(d)
        p["post2"] = zeros(d)
    return p


class LM(nn.Module):
    """What every family holds: the embedding, the final norm's gain and,
    where the embeddings are untied, ``lm_head`` (d, vocab_pad)."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        #: the ``model`` extent whose blocks this model holds (1: whole),
        #: the data extent whose FSDP shards it holds, and that mesh
        self.tp = 1
        self.fsdp = 1
        self.mesh = None
        self.embed = _frozen(tree["embed"])
        self.final_gamma = _frozen(tree["final_gamma"])
        if not cfg.tie_embeddings:
            self.lm_head = _frozen(tree["lm_head"])

    def forward(self, tokens, caches=None, cache_pos=None,
                engine: Optional[str] = None, prefix_embeds=None,
                enc_frames=None, remat: str = "none"):
        return forward(self, self.cfg, tokens, caches=caches,
                       cache_pos=cache_pos, engine=engine,
                       prefix_embeds=prefix_embeds, enc_frames=enc_frames,
                       remat=remat)


class MambaBlock(nn.Module):
    """Pre-norm residual Mamba2 layer: x + mixer(rmsnorm(x, ln1))."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        self.ln1 = _frozen(tree["ln1"])
        self.mamba = M2.Mamba2(cfg, tree["mamba"])


class HybridLM(LM):
    """zamba2: ``blocks`` (n_layers Mamba layers) and one ``shared``
    attention+MLP block; ``state_dict`` names follow the reference pytree
    (``blocks.<i>.mamba.in_proj`` for ``params["blocks"]["mamba"]
    ["in_proj"][i]``)."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(cfg, tree)
        self.blocks = nn.ModuleList(MambaBlock(cfg, b)
                                    for b in tree["blocks"])
        self.shared = ParamTree(tree["shared"])


class DecoderLM(LM):
    """Every family but hybrid: ``blocks`` holds one block per layer, an
    attention (or MLA) + MLP (or MoE) block, with ``ln_x`` and ``xattn``
    where there is an encoder, or rwkv6's ``tmix`` + ``cmix``; the audio
    family adds ``enc_blocks`` (``enc_layers`` attention + MLP blocks) and
    ``enc_final_gamma``.  ``state_dict`` names follow the reference pytree
    (``blocks.<i>.attn.wq``, ``blocks.<i>.moe.w_gate`` for
    ``params["blocks"]["moe"]["w_gate"][i]``, ``blocks.<i>.tmix.wr``,
    ``enc_blocks.<i>.mlp.w_up``, ``lm_head``)."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(cfg, tree)
        self.blocks = nn.ModuleList(ParamTree(b) for b in tree["blocks"])
        if cfg.enc_layers:
            self.enc_blocks = nn.ModuleList(ParamTree(b)
                                            for b in tree["enc_blocks"])
            self.enc_final_gamma = _frozen(tree["enc_final_gamma"])


def model_class(cfg: ArchConfig) -> type:
    _require_ported(cfg)
    return HybridLM if cfg.family == "hybrid" else DecoderLM


def tp_keeper(cfg: ArchConfig, mesh):
    """The ``keep`` that holds each drawn leaf's block on this rank of
    ``mesh`` (`shardings.rank_block`: the tensor-parallel block, and
    within it the FSDP shard over the data axes); raises where ``cfg``
    has no tensor-parallel form over the ``model`` extent."""
    m = SH.model_extent(mesh)
    if m > 1:
        SH.check_tp(cfg, m)
    if m == 1 and SH.data_extent(mesh) == 1:
        return whole
    return lambda name, t: SH.rank_block(name, t, cfg, mesh)


def held_on(model: LM, mesh) -> LM:
    """Record on ``model`` (built from `tp_keeper`'s blocks) the mesh
    whose blocks it holds: ``tp``, ``fsdp``, ``mesh`` and each
    parameter's ``fsdp_dim`` (`shardings.mark_layout`)."""
    model.tp = SH.model_extent(mesh)
    model.fsdp = SH.data_extent(mesh)
    model.mesh = mesh
    SH.mark_layout(model, mesh)
    return model


def init_params(cfg: ArchConfig, seed: int, dtype=torch.float32,
                device=None, mesh=None) -> LM:
    """Random weights from ``seed``, drawn on ``device`` (None = CUDA;
    raises without a card unless ``device="cpu"``).  With a ``mesh``
    (on its rank's device) every leaf is still drawn whole, from the same
    generator in the same order, and the rank keeps its block at once
    (`shardings.rank_block`: its ``model`` block and, where the data
    extent is above 1, its FSDP shard of it): a sharded model holds
    exactly the unsharded model's weights, and the transient memory is
    one leaf."""
    cls = model_class(cfg)
    dev = device_of(mesh, device)
    keep = tp_keeper(cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    tree = {"embed": keep("embed", normal(gen, (cfg.vocab_pad, d), 0.02,
                                          dtype)),
            "final_gamma": zeros(d)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = keep("lm_head", normal(gen, (d, cfg.vocab_pad),
                                                 0.02, dtype))
    if cfg.family == "hybrid":
        tree["blocks"] = [{"ln1": zeros(d), "mamba": _kept(
            keep, "mamba", M2.init_mamba2(gen, cfg, dtype))}
            for _ in range(cfg.n_layers)]
        tree["shared"] = {"ln1": zeros(d),
                          "attn": A.init_attn(gen, cfg, dtype, keep),
                          "ln2": zeros(d),
                          "mlp": _init_mlp(gen, cfg, dtype, keep)}
    else:
        tree["blocks"] = [_init_block(gen, cfg, dtype, zeros,
                                      cross=cfg.enc_layers > 0, keep=keep)
                          for _ in range(cfg.n_layers)]
    if cfg.enc_layers:
        tree["enc_blocks"] = [_init_block(gen, cfg, dtype, zeros, keep=keep)
                              for _ in range(cfg.enc_layers)]
        tree["enc_final_gamma"] = zeros(d)
    return held_on(cls(cfg, tree), mesh)


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.float32, device=None,
                enc_len: Optional[int] = None, mesh=None) -> dict:
    """The reference's cache layouts.  hybrid: ``attn.k/v`` (groups, B,
    max_len, kv, hd), ``ssm`` (layers, B, nh, N, P), ``conv`` (layers, B,
    K−1, C); ssm: ``prev``, ``prev_cm`` (layers, B, d) and ``wkv``
    (layers, B, H, N, P), all f32 and independent of ``max_len``; MLA:
    ``ckv`` (layers, B, max_len, kv_lora), ``kr`` (layers, B, max_len,
    rope_hd); otherwise ``k``/``v`` (layers, B, max_len, kv, hd), and
    with an encoder the cross-attention ``xk``/``xv`` (layers, B,
    ``enc_len`` or ``cfg.enc_positions``, kv, hd), filled at prefill.
    Every leaf has the batch on dim 1.

    With a ``mesh`` (on its rank's device), ``batch`` is the global batch:
    the rank's caches hold its rows of the batch (split over every data
    axis, as `shardings.cache_specs` places them) and, over ``model``,
    the KV heads its query heads read, self- and cross-attention alike
    (`shardings.kv_heads_local`; where ``model`` does not divide them,
    `cache_specs` splits head_dim instead), its Mamba2 heads' ``ssm`` and
    its x channels with all B/C channels of ``conv``, its rwkv6 heads'
    ``wkv``; ``prev``/``prev_cm`` and MLA's ``ckv``/``kr`` are whole
    (`models/shardings.py`).

    A batch that the data axes do not divide (the reference's
    ``cache_specs`` rule: a batch of 1 on a data extent D > 1) stays
    whole on every data rank, and the sequence of ``k``/``v``/``xk``/
    ``xv``/``ckv``/``kr`` is split over ``data``: max_len / D (and
    enc_len / D) positions per rank, each dim that D must divide; the
    O(1) states stay whole.  The caches then come as a
    `shardings.SeqSplitCaches`, which ``forward`` reads as context
    parallelism.  A batch that only some of the data axes divide
    raises."""
    _require_ported(cfg)
    dev = device_of(mesh, device)
    kv_heads, m, split = cfg.n_kv_heads, 1, 1
    if mesh is not None:
        m = SH.model_extent(mesh)
        SH.check_tp(cfg, m)
        dsz = SH.data_extent(mesh)
        axes = SH.batch_axes_for(mesh, batch)
        if axes is None and dsz > 1:
            split = mesh.extent("data")
            if dsz != split:
                raise NotImplementedError(
                    f"a batch of {batch} on data axes "
                    f"{SH.fsdp_axes(mesh.axis_names)}: the sequence splits "
                    f"over 'data' alone, the other axes would replicate it")
        elif axes != SH._fs_entry(mesh.axis_names):
            raise NotImplementedError(
                f"a batch of {batch} splits over {axes}, not every data "
                f"axis of {SH.fsdp_axes(mesh.axis_names)}")
        else:
            batch //= dsz
        if m > 1 and cfg.family != "ssm":
            kv_heads = SH.kv_heads_local(cfg, m)
    out = _caches(cfg, batch, max_len, dtype, dev, enc_len, kv_heads, m,
                  split)
    return SH.SeqSplitCaches(out) if split > 1 else out


def _seq_len(n: int, split: int, what: str) -> int:
    if n % split:
        raise ValueError(f"{what} of {n} does not split over data={split}")
    return n // split


def _caches(cfg, batch, max_len, dtype, dev, enc_len, kv_heads, m, split):
    """`init_caches`' leaves: ``split`` data ranks share each sequence."""
    if cfg.family == "ssm":
        return {name: torch.stack([t] * cfg.n_layers) for name, t in
                R6.init_rwkv6_state(cfg, batch, device=dev,
                                    model=m).items()}
    max_len = _seq_len(max_len, split, "max_len")

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.family == "hybrid":
        kv = (cfg.n_layers // cfg.attn_every, batch, max_len, kv_heads,
              cfg.hd)
        out = {"attn": {"k": zeros(*kv), "v": zeros(*kv)}}
        out.update({name: torch.stack([t] * cfg.n_layers) for name, t in
                    M2.init_mamba2_state(cfg, batch, dtype, dev, m).items()})
        return out
    if cfg.is_mla:
        return {"ckv": zeros(cfg.n_layers, batch, max_len, cfg.kv_lora),
                "kr": zeros(cfg.n_layers, batch, max_len, cfg.rope_head_dim)}
    kv = (cfg.n_layers, batch, max_len, kv_heads, cfg.hd)
    out = {"k": zeros(*kv), "v": zeros(*kv)}
    if cfg.enc_layers:
        xkv = (cfg.n_layers, batch, _seq_len(
            cfg.enc_positions if enc_len is None else enc_len, split,
            "enc_len"), kv_heads, cfg.hd)
        out["xk"], out["xv"] = zeros(*xkv), zeros(*xkv)
    return out


def _mamba_layer(blk, x, cfg, state, engine):
    """x + mixer(rmsnorm(x, ln1)); a state (one layer's ``ssm``/``conv``)
    takes one token and is updated in place."""
    with obs.current().span("model/mamba_layer"):
        blk = SH.gathered(blk)
        y, new_st = M2.mamba2_mixer(blk.mamba,
                                    rmsnorm(x, blk.ln1, cfg.norm_eps), cfg,
                                    state=state, engine=engine)
        if new_st is not None:
            state["ssm"].copy_(new_st["ssm"])
            state["conv"].copy_(new_st["conv"])
        return x + y


def _run_hybrid(model: HybridLM, cfg, x, positions, caches, cache_pos,
                engine, remat, seq_split=False):
    """Groups of `attn_every` Mamba layers, each followed by the shared
    attention+MLP block; ``remat`` wraps each Mamba layer, as in the
    reference."""
    every = cfg.attn_every
    for g in range(cfg.n_layers // every):
        for i in range(g * every, (g + 1) * every):
            st = None if caches is None else {"ssm": caches["ssm"][i],
                                              "conv": caches["conv"][i]}
            x = _remat(functools.partial(
                _mamba_layer, model.blocks[i], cfg=cfg, state=st,
                engine=engine), x, remat)
        kv = None if caches is None else {"k": caches["attn"]["k"][g],
                                          "v": caches["attn"]["v"][g]}
        with obs.current().span("model/shared_block"):
            sh = SH.gathered(model.shared)
            a, _ = A.attention(sh.attn, rmsnorm(x, sh.ln1, cfg.norm_eps),
                               cfg, positions, cache=kv, cache_pos=cache_pos,
                               seq_split=seq_split)
            x = x + a
            x = x + _mlp(sh.mlp, rmsnorm(x, sh.ln2, cfg.norm_eps), cfg)
    return x


def layer_window(cfg: ArchConfig, layer: int) -> Optional[int]:
    """The sliding window of ``layer`` (None = global): even layers are
    local when the config alternates local and global layers, else every
    layer has the config's window, if any."""
    if cfg.window and (not cfg.local_global_alternate or layer % 2 == 0):
        return cfg.window
    return None


def _rwkv_block(p, x, cfg, cache):
    """x + time mix, then + channel mix, each on its pre-norm; a cache
    (one layer's ``prev``/``wkv``/``prev_cm``) takes one token and is
    updated in place."""
    with obs.current().span("model/rwkv_block"):
        p = SH.gathered(p)
        st = None if cache is None else {"prev": cache["prev"],
                                         "wkv": cache["wkv"]}
        t, new_t = R6.rwkv6_time_mix(p.tmix, rmsnorm(x, p.ln1, cfg.norm_eps),
                                     cfg, st)
        x = x + t
        c, new_cm = R6.rwkv6_channel_mix(
            p.cmix, rmsnorm(x, p.ln2, cfg.norm_eps),
            None if cache is None else cache["prev_cm"])
        if cache is not None:
            cache["prev"].copy_(new_t["prev"])
            cache["wkv"].copy_(new_t["wkv"])
            cache["prev_cm"].copy_(new_cm)
        return x + c


def _dense_block(p, x, cfg, positions, window, cache, cache_pos,
                 enc_out=None, seq_split=False):
    with obs.current().span("model/dense_block"):
        p = SH.gathered(p)
        h = rmsnorm(x, p.ln1, cfg.norm_eps)
        if cfg.is_mla:
            a, _ = MLA.mla_attention(p.attn, h, cfg, positions, cache=cache,
                                     cache_pos=cache_pos, seq_split=seq_split)
        else:
            a, _ = A.attention(p.attn, h, cfg, positions, window=window,
                               cache=cache, cache_pos=cache_pos,
                               seq_split=seq_split)
        if cfg.local_global_alternate:
            a = rmsnorm(a, p.post1, cfg.norm_eps)
        x = x + a
        if enc_out is not None or (cache is not None and "xk" in cache):
            # cross-attention: K/V from the encoder's output (written to the
            # cache when there is one), else from the cache
            if enc_out is not None:
                kv = A.init_cross_kv(p.xattn, enc_out, cfg)
                if cache is not None:
                    n = cache["xk"].shape[1]
                    lo = (SH.current_mesh().axis_index("data") * n if seq_split
                          else 0)
                    cache["xk"].copy_(kv[0][:, lo:lo + n])
                    cache["xv"].copy_(kv[1][:, lo:lo + n])
            else:
                kv = (cache["xk"], cache["xv"])
            cx, _ = A.attention(p.xattn, rmsnorm(x, p.ln_x, cfg.norm_eps), cfg,
                                positions, kv_override=kv,
                                seq_split=seq_split and enc_out is None)
            x = x + cx
        h2 = rmsnorm(x, p.ln2, cfg.norm_eps)
        if cfg.is_moe:
            # per-row cursors: each row dispatches alone, as each slot does in
            # the reference's per-slot decode
            f = MOE.moe_ffn_a2a(p.moe, h2, cfg,
                                per_row=torch.is_tensor(cache_pos),
                                whole_batch=seq_split)
        else:
            f = _mlp(p.mlp, h2, cfg)
        if cfg.local_global_alternate:
            f = rmsnorm(f, p.post2, cfg.norm_eps)
        return x + f


def _run_decoder(model: DecoderLM, cfg, x, positions, caches, cache_pos,
                 enc_out=None, remat: str = "none", seq_split=False):
    for i, blk in enumerate(model.blocks):
        cache = (None if caches is None
                 else {name: c[i] for name, c in caches.items()})
        if cfg.family == "ssm":
            body = functools.partial(_rwkv_block, blk, cfg=cfg, cache=cache)
        else:
            body = functools.partial(
                _dense_block, blk, cfg=cfg, positions=positions,
                window=layer_window(cfg, i), cache=cache,
                cache_pos=cache_pos, enc_out=enc_out, seq_split=seq_split)
        x = _remat(body, x, remat)
    return x


def _enc_block(p, x, cfg, pos):
    with obs.current().span("model/encoder_block"):
        p = SH.gathered(p)
        a, _ = A.attention(p.attn, rmsnorm(x, p.ln1, cfg.norm_eps), cfg, pos,
                           is_causal=False)
        x = x + a
        return x + _mlp(p.mlp, rmsnorm(x, p.ln2, cfg.norm_eps), cfg)


def _run_encoder(model: DecoderLM, cfg, frames, remat: str = "none"):
    """The audio encoder over stub frame embeddings (B, F, d):
    non-causal attention + MLP blocks at RoPE positions 0..F−1, then the
    final norm."""
    x = frames
    pos = torch.arange(frames.shape[1], device=frames.device)
    for p in model.enc_blocks:
        x = _remat(functools.partial(_enc_block, p, cfg=cfg, pos=pos), x,
                   remat)
    return rmsnorm(x, model.enc_final_gamma, cfg.norm_eps)


def forward(model: LM, cfg: ArchConfig, tokens, *, prefix_embeds=None,
            enc_frames=None, caches=None, cache_pos=None,
            engine: Optional[str] = None, remat: str = "none"):
    """Returns (logits, caches).

    tokens: (B, S) integer.  prefix_embeds: (B, P, d) stub modality
    embeddings put before the token embeddings (vlm).  enc_frames: (B, F,
    d) stub audio frames: the encoder runs only when they are given (with
    caches, its cross K/V are written to ``xk``/``xv``, whose F they must
    match; without frames a cache's ``xk``/``xv`` are read, and with
    neither the decoder has no cross term).  caches + cache_pos (an int or
    a (B,) tensor of per-row cursors) → decode or prefill-with-cache mode,
    caches updated in place (the hybrid and ssm families take one token
    per row).  ``engine`` picks the Mamba2 scan of the hybrid family's
    full-sequence path (None: the CUDA kernel on a CUDA model, the chunked
    torch path on the CPU; the kernel has no backward, so training passes
    ``"chunked"``).  ``remat`` ("none", "full" or "dots", see `REMAT`)
    recomputes each block in the backward pass.

    Grad mode is the caller's; with caches it must be off unless no
    parameter requires a gradient (serving runs under ``no_grad``).  The
    current mesh must be the one whose blocks the model holds (its
    ``model`` and data extents).  With `shardings.SeqSplitCaches` every
    data rank passes the whole batch and gets the whole logits.

    Spans (`obs`): ``model/forward`` holds one span per block
    (``model/mamba_layer``, ``model/shared_block``, ``model/dense_block``,
    ``model/rwkv_block``, ``model/encoder_block``; a block that ``remat``
    recomputes is recorded again in the backward) and ``model/head``.
    """
    with obs.current().span("model/forward"):
        _require_ported(cfg)
        grads = (torch.is_grad_enabled()
                 and any(p.requires_grad for p in model.parameters()))
        if caches is not None and grads:
            raise RuntimeError("forward with caches while grad mode is on and "
                               "parameters require grad: training passes no "
                               "caches, serving runs under torch.no_grad()")
        mesh = SH.current_mesh()
        m, dsz = SH.model_extent(mesh), SH.data_extent(mesh)
        if m != model.tp or dsz != model.fsdp:
            raise ValueError(f"the model holds blocks for model={model.tp}, "
                             f"data={model.fsdp}; the current mesh has "
                             f"model={m}, data={dsz}")
        if m > 1:
            SH.check_tp(cfg, m)
        seq_split = isinstance(caches, SH.SeqSplitCaches)
        if seq_split and (mesh is None or "data" not in mesh.axis_names):
            raise ValueError("sequence-split caches need a mesh with a 'data' "
                             "axis")
        tokens = torch.as_tensor(tokens, device=model.embed.device)
        embed = SH.fsdp_gather(model.embed)
        x = _embed(embed, tokens, m) * math.sqrt(cfg.d_model)
        if prefix_embeds is not None:
            x = torch.cat([torch.as_tensor(prefix_embeds, device=x.device)
                           .to(x.dtype), x], 1)
        x = SH.constrain_residual(x)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None]
        if torch.is_tensor(cache_pos):
            positions = cache_pos.reshape(-1, 1) + positions
        elif cache_pos is not None:
            positions = positions + int(cache_pos)
        positions = positions.expand(b, s)
        enc_out = None
        if cfg.enc_layers and enc_frames is not None:
            frames = torch.as_tensor(enc_frames, device=x.device).to(x.dtype)
            n_x = None if caches is None else caches["xk"].shape[2] * (
                mesh.extent("data") if seq_split else 1)
            if caches is not None and n_x != frames.shape[1]:
                raise ValueError(
                    f"{frames.shape[1]} encoder frames for a cross-attention "
                    f"cache of {n_x}: pass enc_len= to init_caches")
            enc_out = _run_encoder(model, cfg, frames, remat)
        if cfg.family == "hybrid":
            x = _run_hybrid(model, cfg, x, positions, caches, cache_pos,
                            engine, remat, seq_split)
        else:
            x = _run_decoder(model, cfg, x, positions, caches, cache_pos,
                             enc_out, remat, seq_split)
        with obs.current().span("model/head"):
            x = rmsnorm(SH.constrain_residual(x), model.final_gamma,
                        cfg.norm_eps)
            # the tied embedding: one gather, its gradient from both uses
            # summed before the reduce-scatter
            head = (embed.T if cfg.tie_embeddings
                    else SH.fsdp_gather(model.lm_head))
            logits = SH.constrain_logits(
                SH.tp_gather(SH.tp_enter(x) @ head, -1))
            return softcap(logits.float(), cfg.final_logit_softcap), caches


def _embed(embed: torch.Tensor, tokens, m: int) -> torch.Tensor:
    """The embedding rows of ``tokens``; at a ``model`` extent m > 1 the
    rank holds a block of vocab rows: it looks up the tokens inside it,
    zeroes the others, and the rows are summed over model."""
    if m == 1:
        return embed[tokens]
    v_loc = embed.shape[0]
    ids = tokens - SH.current_mesh().axis_index("model") * v_loc
    mine = (ids >= 0) & (ids < v_loc)
    rows = embed[ids.clamp(0, v_loc - 1)]
    return SH.tp_psum(torch.where(mine[..., None], rows, 0.0))
