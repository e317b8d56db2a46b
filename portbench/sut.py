"""The system under test: the one module of the benchmark that imports
the port (``repro_torch``).  It builds the port's model on the weights the
benchmark drew (the port holds them as they are, no copy) and exposes the
two entries the loops time: ``transformer.forward`` and the step of
``train_step.make_train_step``."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_opt_state, make_train_step

from portbench.reference import common


def port_config(cfg: dict) -> ArchConfig:
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in cfg.items() if k in fields})


def build(cfg: dict, w: dict):
    """The port's model holding the tensors ``w`` (dotted names)."""
    pc = port_config(cfg)
    model = T.held_on(T.model_class(pc)(pc, common.tree(w)), None)
    names = {n for n, _ in model.named_parameters()}
    if names != set(w):
        raise RuntimeError(f"the port's parameters and the benchmark's "
                           f"weights differ: {sorted(names ^ set(w))[:8]}")
    return pc, model


class Scorer:
    """``forward(tokens)`` → the logits of ``transformer.forward`` on the
    port's default path (the CUDA kernels on a CUDA model)."""

    def __init__(self, cfg: dict, traffic: dict, w: dict):
        self.pc, self.model = build(cfg, w)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
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
