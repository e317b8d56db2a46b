"""The system under test: the one module of the benchmark that imports
the port (``repro_torch``).  It builds the port's model on the weights the
benchmark drew (the port holds them as they are, no copy) and exposes the
two entries the loops time: ``transformer.forward`` and the step of
``train_step.make_train_step``.  For a cell of several chips it builds the
port's mesh over the ranks (`mesh`) and cuts the weights to each rank's
blocks in the port's layout (`rank_weights`)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import shardings as SH
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_opt_state, make_train_step

from portbench.reference import common


def port_config(cfg: dict) -> ArchConfig:
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in cfg.items() if k in fields})


def mesh(shape: dict, device):
    """The port's mesh of ``shape`` ({axis: extent}, as {"data": 1,
    "model": 4}) over the ranks of the default process group."""
    return make_mesh(tuple(shape.values()), tuple(shape), device=device)


def rank_weights(cfg: dict, spec: list, seed: int, device, mesh) -> dict:
    """This rank's blocks (``shardings.rank_block``, the port's layout on
    ``mesh``) of the weights of ``spec`` drawn from ``seed``: one group
    drawn whole at a time, each leaf cut to its block, the group freed.
    A block that is the whole leaf is copied out of the group's buffer,
    so the rank holds its share and never more than one whole group
    besides."""
    keep = T.tp_keeper(port_config(cfg), mesh)
    out = {}
    for group in common.groups_of(spec):
        whole = common.draw(spec, seed, device, only=group)
        for name, t in whole.items():
            b = keep(name, t)
            same = b.untyped_storage().data_ptr() == \
                t.untyped_storage().data_ptr()
            out[name] = b.clone() if same else b
        del whole, t, b
    return out


def build(cfg: dict, w: dict, mesh=None):
    """The port's model holding the tensors ``w`` (dotted names; on a
    ``mesh``, the rank's blocks)."""
    pc = port_config(cfg)
    model = T.held_on(T.model_class(pc)(pc, common.tree(w)), mesh)
    names = {n for n, _ in model.named_parameters()}
    if names != set(w):
        raise RuntimeError(f"the port's parameters and the benchmark's "
                           f"weights differ: {sorted(names ^ set(w))[:8]}")
    return pc, model


class Scorer:
    """``forward(tokens)`` → the logits of ``transformer.forward`` on the
    port's default path (the CUDA kernels on a CUDA model); on a ``mesh``
    the whole logits, on every rank."""

    def __init__(self, cfg: dict, traffic: dict, w: dict, mesh=None):
        self.mesh = mesh
        self.pc, self.model = build(cfg, w, mesh)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), SH.use_mesh(self.mesh):
            return T.forward(self.model, self.pc, tokens)[0]


class Trainer:
    """The step of ``make_train_step`` with its model and AdamW state;
    ``step(tokens)`` runs one on a (B, S+1) batch and returns the loss."""

    def __init__(self, cfg: dict, traffic: dict, w: dict):
        self.pc, self.model = build(cfg, w)
        opt = OptConfig(**traffic["optimizer"])
        self.b1 = opt.b1
        self.fn = make_train_step(self.pc, opt, remat=traffic["remat"],
                                  grad_compress=traffic["grad_compress"],
                                  microbatches=traffic["microbatches"])
        self.state = init_opt_state(self.model,
                                    grad_compress=traffic["grad_compress"])

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        _, _, metrics = self.fn(self.model, self.state, {"tokens": tokens})
        return metrics["loss"]

    def first_grad_norms(self) -> dict:
        """After the first step: each leaf's gradient as AdamW took it
        (clipped), read back from the first moment, mu = (1 − b1)·g."""
        return {n: (m / (1 - self.b1)).norm()
                for n, m in self.state["mu"].items()}

    def params(self) -> dict:
        return {n: p.detach() for n, p in self.model.named_parameters()}
