"""Training step (port of ``repro/train/train_step.py``): next-token loss,
grads, AdamW, with optional int8 error-feedback gradient compression and
gradient accumulation over microbatches.

The reference's step is pure (new params and optimizer state out); this
one updates the model's parameters and the optimizer state in place, as
the port's forward updates caches in place.

Under a mesh (``shardings.use_mesh``) the model holds its blocks of the
mesh (`shardings.rank_block`) and each rank passes its rows of the
global batch.  The backward gives every leaf its gradient as the rank
holds the leaf: the FSDP gathers reduce-scatter the gradients of the
sharded leaves (summed over the data ranks), and the ``model``-axis
collectives have the backward that their transpose gives them
(`core.mesh`).  `average_over_data` then divides the sharded leaves'
gradients by the data extent and averages the others (and the loss)
over the data axes, so the compression and AdamW see the global batch's
gradient, as the reference's do under pjit: the int8 scale of a leaf is
the max over every rank that holds a part of it, the error feedback
stays per shard, and the clip's global norm counts each element once
(`optimizer.global_norm`).  Every rank's parameters and moments are its
blocks; a replicated leaf takes the same update on every rank.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.models import shardings as SH
from repro_torch.models import transformer as T
from repro_torch.models.weights import leaf_groups
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update


def next_token_loss(model, cfg: ArchConfig, batch: dict,
                    remat: str = "full") -> torch.Tensor:
    """batch: ``tokens`` (B, S+1) [+ ``prefix_embeds`` / ``enc_frames``
    stubs]; the mean next-token NLL over the text positions.  The hybrid
    family runs its chunked scan: the SSD kernel has no backward."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    kw = {}
    if cfg.n_prefix_embeds:
        kw["prefix_embeds"] = batch["prefix_embeds"]
    if cfg.enc_layers:
        kw["enc_frames"] = batch["enc_frames"]
    if cfg.family == "hybrid":
        kw["engine"] = "chunked"
    logits, _ = T.forward(model, cfg, inputs, remat=remat, **kw)
    # modality prefixes don't predict tokens: score text positions only
    if cfg.n_prefix_embeds:
        logits = logits[:, cfg.n_prefix_embeds:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = torch.as_tensor(labels, device=logp.device).long()
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


def group_amax(gs: list) -> torch.Tensor:
    """The max |g| over the tensors ``gs`` of one reference leaf and, under
    a mesh, over every rank that holds a part of it (a pmax over each
    axis: the leaf's blocks on the data and model ranks)."""
    amax = torch.stack([g.abs().max() for g in gs]).max()
    mesh = SH.current_mesh()
    if mesh is not None and mesh.size > 1:
        for a in mesh.axis_names:
            if mesh.extent(a) > 1:
                amax = mesh.pmax(amax.reshape(1), a)[0]
    return amax


def _compress_group(gs: list, errs: list) -> tuple:
    """int8 quantization with error feedback (1-bit-Adam style) of the
    tensors that make one reference leaf, with ONE scale over all of
    them (`group_amax`), as the reference takes over the stacked leaf.
    Returns the dequantized gradients and the new errors."""
    gs = [g.float() + e for g, e in zip(gs, errs)]
    scale = group_amax(gs) / 127.0 + 1e-12
    deq = [torch.clamp(torch.round(g / scale), -127, 127)
           .to(torch.int8).float() * scale for g in gs]
    return deq, [g - d for g, d in zip(gs, deq)]


def _compress_int8(g: torch.Tensor, err: torch.Tensor) -> tuple:
    """One tensor's int8 quantization with error feedback: (deq, err)."""
    (deq,), (new_err,) = _compress_group([g], [err])
    return deq, new_err


@torch.no_grad()
def compress_grads(model, err: dict) -> None:
    """Replace every ``.grad`` by its int8 dequantization, one scale per
    reference leaf (`weights.leaf_groups`), and write the new residuals
    into ``err`` (keyed by parameter name), all in place."""
    params = dict(model.named_parameters())
    for leaf in leaf_groups(model).values():
        deq, new = _compress_group([params[n].grad for n in leaf.names],
                                   [err[n] for n in leaf.names])
        for n, d, e in zip(leaf.names, deq, new):
            params[n].grad.copy_(d)
            err[n].copy_(e)


@torch.no_grad()
def average_over_data(model, loss: torch.Tensor, mesh) -> torch.Tensor:
    """Make every ``.grad`` the mean over the data axes of ``mesh`` (in
    place) and return the mean of ``loss``: the gradient and loss of the
    global batch, when each rank holds an equal share of its rows.  An
    FSDP shard's gradient arrives summed over the data ranks (the
    gather's reduce-scatter) and is divided by the data extent; a leaf
    the data axes do not shard is psummed over them first."""
    axes = [a for a in SH.fsdp_axes(mesh.axis_names) if mesh.extent(a) > 1]
    if not axes:
        return loss
    n = SH.data_extent(mesh)
    loss = loss.detach().clone().reshape(1)
    summed = [p.grad for p in model.parameters() if p.grad is not None
              and getattr(p, "fsdp_dim", None) is not None]
    partial = [p.grad for p in model.parameters() if p.grad is not None
               and getattr(p, "fsdp_dim", None) is None] + [loss]
    flat = torch.cat([t.reshape(-1) for t in partial])
    for a in axes:
        mesh.psum(flat, a)
    for t, part in zip(partial, flat.split([t.numel() for t in partial])):
        t.copy_(part.view_as(t))
    for t in summed + partial:
        t.div_(n)
    return loss[0]


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig,
                    remat: str = "full", grad_compress: bool = False,
                    microbatches: int = 1):
    """Returns ``train_step(model, opt_state, batch) → (model, opt_state,
    metrics)``, which turns on the model's gradients and updates it and
    ``opt_state`` in place; ``metrics`` (``loss``, ``lr``,
    ``grad_norm``) are 0-d tensors on the model's device.

    Under a mesh (module docstring) ``batch`` holds the rank's rows.

    ``microbatches`` > 1 splits the batch along dim 0 and accumulates one
    backward per microbatch, scaled by 1/microbatches as the reference's
    scan: peak activation memory shrinks, FLOPs stay.  ``grad_compress``
    needs the ``err`` dict of ``init_opt_state(..., grad_compress=True)``.
    """

    def grads_of(model, batch):
        """The loss, with the (accumulated) gradients left in ``.grad``."""
        params = list(model.parameters())
        for p in params:
            p.grad = None
        rows = batch["tokens"].shape[0]
        if rows % microbatches:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{microbatches} microbatches")
        parts = [dict(zip(batch, mb)) for mb in zip(
            *(torch.as_tensor(v).chunk(microbatches) for v in batch.values()))]
        lsum = 0.0
        for mb in parts:
            loss = next_token_loss(model, cfg, mb, remat)
            loss.backward()
            lsum = lsum + loss.detach()
        if microbatches > 1:
            for p in params:
                p.grad.mul_(1.0 / microbatches)
        return lsum * (1.0 / microbatches)

    def train_step(model, opt_state, batch):
        tokens = batch["tokens"]
        with obs.current().span("train/step",
                                tokens=int(tokens.shape[0]
                                           * (tokens.shape[1] - 1))):
            model.requires_grad_(True)
            loss = grads_of(model, batch)
            mesh = SH.current_mesh()
            if mesh is not None:
                loss = average_over_data(model, loss, mesh)
            if grad_compress:
                compress_grads(model, opt_state["err"])
            metrics = adamw_update(model, opt_state, opt_cfg)
            metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def init_opt_state(model, grad_compress: bool = False) -> dict:
    st = adamw_init(model)
    if grad_compress:
        st["err"] = {n: torch.zeros_like(m) for n, m in st["mu"].items()}
    return st
