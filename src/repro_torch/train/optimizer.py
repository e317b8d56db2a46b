"""AdamW and learning-rate schedules (port of ``repro/train/optimizer.py``).

Includes the WSD (warmup–stable–decay) schedule minicpm trains with
(arXiv:2404.06395) and standard cosine.  The update reads each
parameter's ``.grad`` and writes the parameters and moments in place.
Under a mesh the parameters, gradients and moments are the rank's blocks
(`shardings.rank_block`): the update is elementwise, the clip's norm is
summed over the ranks with each element of a leaf counted once
(`grad_norm`), and weight decay still goes by the reference leaf's rank.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import obs
from repro_torch.models import shardings as SH
from repro_torch.models.weights import leaf_groups


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "wsd"            # wsd | cosine | const
    warmup_steps: int = 100
    stable_steps: int = 1000
    decay_steps: int = 100
    min_lr_frac: float = 0.1


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor, kept on its
    device: no host sync) as a 0-d f32 tensor."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp((s + 1.0) / cfg.warmup_steps, max=1.0)
    if cfg.schedule == "const":
        return cfg.peak_lr * warm
    if cfg.schedule == "cosine":
        total = cfg.stable_steps + cfg.decay_steps
        t = torch.clamp((s - cfg.warmup_steps) / total, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return cfg.peak_lr * warm * (cfg.min_lr_frac
                                     + (1 - cfg.min_lr_frac) * cos)
    # WSD: warmup → stable plateau → sharp decay (minicpm)
    in_decay = s > (cfg.warmup_steps + cfg.stable_steps)
    t = torch.clamp((s - cfg.warmup_steps - cfg.stable_steps)
                    / cfg.decay_steps, 0.0, 1.0)
    decay = torch.pow(cfg.min_lr_frac, t)
    return cfg.peak_lr * warm * torch.where(in_decay, decay, 1.0)


def adamw_init(model) -> dict:
    """``mu`` and ``nu``: f32 zeros per parameter, keyed by the
    ``named_parameters`` names; ``step``: a 0-d int32 tensor, all on the
    model's device."""
    named = list(model.named_parameters())
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in named}
    return {"mu": zeros, "nu": {n: torch.zeros_like(z)
                                for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32,
                                device=named[0][1].device)}


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def grad_norm(model) -> torch.Tensor:
    """The global norm of the model's ``.grad``s: `global_norm` without a
    mesh; under one, each rank's sum of squares over what it counts of
    each leaf (`shardings.counted_once`: a replicated block on one rank,
    Mamba2's B/C columns on model rank 0) psummed over every axis, so
    each element of every leaf counts once."""
    named = list(model.named_parameters())
    mesh = SH.current_mesh()
    if mesh is None or mesh.size == 1:
        return global_norm(p.grad for _, p in named)
    total = torch.zeros(1, device=named[0][1].device)
    for name, p in named:
        part = SH.counted_once(name, p.grad, model.cfg, mesh)
        if part is False:
            continue
        g = p.grad.float() if part is True else p.grad.float()[..., part]
        total += torch.sum(torch.square(g))
    for a in mesh.axis_names:
        if mesh.extent(a) > 1:
            mesh.psum(total, a)
    return torch.sqrt(total[0])


def decayed(model) -> set:
    """The parameter names AdamW decays: those whose *reference* leaf has
    rank ≥ 2.  The reference stacks every block leaf along the layer
    axis, so it decays the per-layer norms and vectors (``blocks.ln1`` is
    (L, d)) and leaves only the unstacked vectors (``final_gamma``,
    zamba2's ``shared.ln1``) alone."""
    return {n for leaf in leaf_groups(model).values() if leaf.ndim >= 2
            for n in leaf.names}


@torch.no_grad()
def adamw_update(model, opt_state: dict, cfg: OptConfig) -> dict:
    """One AdamW step from the parameters' ``.grad`` (clipped to a global
    norm of ``cfg.grad_clip``, bias-corrected, at the scheduled rate,
    decaying the `decayed` names), applied in place to the parameters and
    to ``opt_state``'s ``mu``, ``nu`` and ``step``.  Returns ``lr`` and
    ``grad_norm`` as 0-d tensors, with no host sync."""
    decay = decayed(model)
    named = list(model.named_parameters())
    step = opt_state["step"] + 1
    with obs.current().span("train/clip"):
        gn = grad_norm(model)
        scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    s = step.float()
    bc1 = 1 - torch.pow(b1, s)
    bc2 = 1 - torch.pow(b2, s)
    for name, p in named:
        mu, nu = opt_state["mu"][name], opt_state["nu"][name]
        g = p.grad.float() * scale
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if name in decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    opt_state["step"].copy_(step)
    return {"lr": lr, "grad_norm": gn}
