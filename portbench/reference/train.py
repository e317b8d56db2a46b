"""The configuration's training step in plain PyTorch: the mean next-token
negative log-likelihood over the whole batch (the softmax over the padded
vocabulary), its gradient (each layer recomputed in the backward pass,
one row at a time so that it fits), the gradient clipped to a global
norm, and AdamW with bias correction, decoupled weight decay and the WSD
learning rate.  It has the interface of ``sut.Trainer``."""
from __future__ import annotations

import torch


def wsd_lr(opt: dict, n: int) -> float:
    """The learning rate of update n (1, 2, ...): a linear warm-up that
    reaches the peak at update ``warmup_steps`` − 1, a plateau, then an
    exponential decay to ``min_lr_frac`` of the peak over
    ``decay_steps``."""
    warm = min((n + 1) / opt["warmup_steps"], 1.0)
    past = n - opt["warmup_steps"] - opt["stable_steps"]
    decay = (opt["min_lr_frac"] ** min(past / opt["decay_steps"], 1.0)
             if past > 0 else 1.0)
    return opt["peak_lr"] * warm * decay


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    picked = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - picked).mean()


class Trainer:
    def __init__(self, family, cfg: dict, traffic: dict, w: dict):
        self.family, self.cfg, self.opt = family, cfg, traffic["optimizer"]
        self.w = w
        for t in w.values():
            t.requires_grad_(True)
        self.mu = {n: torch.zeros_like(t) for n, t in w.items()}
        self.nu = {n: torch.zeros_like(t) for n, t in w.items()}
        self.decayed = set(w) - family.no_decay(cfg)
        self.n = 0
        self.first = None

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        for t in self.w.values():
            t.grad = None
        rows = tokens.shape[0]
        loss = torch.zeros((), device=tokens.device)
        for r in range(rows):
            row = tokens[r:r + 1]
            logits = self.family.forward(self.w, self.cfg, row[:, :-1],
                                         remat=True)
            part = nll(logits, row[:, 1:]) / rows
            part.backward()
            loss += part.detach()
        o = self.opt
        with torch.no_grad():
            norm = torch.sqrt(sum(t.grad.pow(2).sum() for t in self.w.values()))
            scale = torch.clamp(o["grad_clip"] / (norm + 1e-9), max=1.0)
            self.n += 1
            lr = wsd_lr(o, self.n)
            bc1, bc2 = 1 - o["b1"] ** self.n, 1 - o["b2"] ** self.n
            if self.n == 1:
                self.first = {n: (t.grad * scale).norm()
                              for n, t in self.w.items()}
            for name, p in self.w.items():
                g = p.grad * scale
                mu, nu = self.mu[name], self.nu[name]
                mu.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                nu.mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
                delta = (mu / bc1) / (torch.sqrt(nu / bc2) + o["eps"])
                if name in self.decayed:
                    delta = delta + o["weight_decay"] * p
                p.sub_(lr * delta)
                p.grad = None
        return loss

    def first_grad_norms(self) -> dict:
        return self.first

    def params(self) -> dict:
        return {n: t.detach() for n, t in self.w.items()}


class Scorer:
    """The family's forward, in the interface of ``sut.Scorer``: the
    batch's rows in blocks of ``ROWS``, so that the plain attention's
    (rows, heads, L, L) scores fit beside the logits at a full batch."""

    ROWS = 4

    def __init__(self, family, cfg: dict, traffic: dict, w: dict):
        self.family, self.cfg, self.w = family, cfg, w

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return torch.cat([self.family.forward(self.w, self.cfg, part)
                              for part in tokens.split(self.ROWS)])
