"""Faults planted in the timed path, for checking that ``correct`` catches
them (``test_portbench_faults.py``, ``calibrate.py``).  Each wraps the
port's scorer or trainer:

  half       half of the batch left out: the first half stands in for the
             rest, so the mean is taken over it alone;
  token      an answer altered where it is produced: in every sequence one
             position's logits replaced by the next one's, or one input
             token of a training batch changed;
  unchanged  (training) a step that returns its state unchanged: the loss
             of the batch, and no update.

and, for a run on several ranks, a rank that fails in the window (its
third forward, the second of the window): on rank 1

  raise      raises;
  stall      stops answering (sleeps for an hour).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from portbench import sut


def _halved(tokens: torch.Tensor) -> torch.Tensor:
    half = tokens.shape[0] // 2
    return torch.cat([tokens[:half]] * 2)


class HalfScorer(sut.Scorer):
    def forward(self, tokens):
        return super().forward(_halved(tokens))


class TokenScorer(sut.Scorer):
    def forward(self, tokens):
        out = super().forward(tokens).clone()
        out[:, -2] = out[:, -1]
        return out


class HalfTrainer(sut.Trainer):
    def step(self, tokens):
        return super().step(_halved(tokens))


class TokenTrainer(sut.Trainer):
    def step(self, tokens):
        bad = tokens.clone()
        bad[0, bad.shape[1] // 2] = (bad[0, bad.shape[1] // 2] + 1) % \
            self.pc.vocab
        return super().step(bad)


class UnchangedTrainer(sut.Trainer):
    def step(self, tokens):
        from repro_torch.train.train_step import next_token_loss
        with torch.no_grad():
            return next_token_loss(self.model, self.pc, {"tokens": tokens})


class FailingScorer(sut.Scorer):
    how = "raise"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.calls = 0

    def forward(self, tokens):
        self.calls += 1
        if self.calls == 3 and dist.get_rank() == 1:
            if self.how == "raise":
                raise RuntimeError("a fault planted on rank 1")
            time.sleep(3600)
        return super().forward(tokens)


class StallingScorer(FailingScorer):
    how = "stall"


SCORE = {"half": HalfScorer, "token": TokenScorer, "raise": FailingScorer,
         "stall": StallingScorer}
TRAIN = {"half": HalfTrainer, "token": TokenTrainer,
         "unchanged": UnchangedTrainer}


def make(name: str):
    """The (scorer, trainer) factories with fault ``name`` planted."""
    return SCORE.get(name, sut.Scorer), TRAIN.get(name, sut.Trainer)
