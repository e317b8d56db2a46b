"""Serving steps: prefill + decode (port of ``repro/serve/serve_step.py``).

Both steps emit an ambient-recorder span (`obs.use`); with no recorder
installed the cost is one attribute read on the NULL singleton.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def prefill_step(model, cfg: ArchConfig, tokens, caches,
                 stepwise: bool = False):
    """Fill the caches with the prompt ``tokens`` (B, L) from position 0;
    returns (last_token_logits, caches).

    Families whose caches are indexed only by position run the prompt as
    one full-sequence forward at ``cache_pos=0``, as the reference does.
    The hybrid family, or any family when ``stepwise``, runs it one token
    at a time: the Mamba2 mixer's state path takes one step per call (the
    reference's full-sequence prefill on the hybrid family reads only
    step 0 of the prompt's state inputs), and the JAX batcher prefills
    every family token by token."""
    rec = obs.current()
    with rec.span("serve/prefill_step",
                  tokens=int(tokens.shape[0] * tokens.shape[1])):
        if stepwise or cfg.family == "hybrid":
            for t in range(tokens.shape[1]):
                logits, caches = T.forward(model, cfg, tokens[:, t:t + 1],
                                           caches=caches, cache_pos=t)
        else:
            logits, caches = T.forward(model, cfg, tokens, caches=caches,
                                       cache_pos=0)
    return logits[:, -1], caches


def decode_step(model, cfg: ArchConfig, last_token, caches, pos):
    """One token in, one token out; O(cache) attention / O(1) SSM state.
    last_token: (B, 1) integer; pos: an int or a (B,) tensor of per-row
    cursors (tokens already cached)."""
    rec = obs.current()
    with rec.span("serve/decode_step", batch=int(last_token.shape[0])):
        logits, caches = T.forward(model, cfg, last_token, caches=caches,
                                   cache_pos=pos)
    return logits[:, -1], caches


def greedy_token(logits: torch.Tensor, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Argmax at temperature 0; otherwise a draw from softmax(logits / T)
    with the caller's ``generator`` (required)."""
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")
    probs = torch.softmax(logits.float() / temperature, -1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0] \
        .to(torch.int32)
