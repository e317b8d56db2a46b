"""Serving steps: prefill + decode (port of ``repro/serve/serve_step.py``).

Both steps emit an ambient-recorder span (`obs.use`); with no recorder
installed the cost is one attribute read on the NULL singleton.  Both
run under ``torch.no_grad()``: serving a model that has just trained
builds no graph.

Under a mesh (``shardings.use_mesh``) with caches from
``transformer.init_caches(..., mesh=)``: where the data axes divide the
batch, each rank passes its rows; where they do not (B = 1, the
reference's long-context decode), every data rank passes the whole batch
and its caches hold its share of the sequence
(`shardings.SeqSplitCaches`).  ``cache_pos`` is then the global position
(an int: every row at one position), each rank writes only the
positions it owns, and every rank gets the whole logits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


@torch.no_grad()
def prefill_step(model, cfg: ArchConfig, tokens, caches,
                 stepwise: bool = False, enc_frames=None,
                 prefix_embeds=None):
    """Fill the caches with the prompt ``tokens`` (B, L) from position 0;
    returns (last_token_logits, caches).  ``enc_frames`` (B, F, d): the
    audio family's stub frames, whose encoder output fills the
    cross-attention cache (``xk``/``xv``).  ``prefix_embeds`` (B, P, d):
    the vlm family's stub modality embeddings, cached at positions
    0..P−1 before the prompt (decoding then goes on from P + L).

    Families whose caches are indexed only by position run the prompt as
    one full-sequence forward at ``cache_pos=0``, as the reference does.
    The hybrid and ssm families, or any family when ``stepwise``, run it
    one token at a time (the frames go with token 0): the Mamba2 and
    rwkv6 mixers' state paths take one step per call (the reference's
    full-sequence prefill on those families reads only step 0 of the
    prompt's state inputs), and the JAX batcher prefills every family
    token by token."""
    rec = obs.current()
    one_by_one = stepwise or cfg.family in ("hybrid", "ssm")
    if prefix_embeds is not None and one_by_one:
        raise ValueError("prefix_embeds go with a one-forward prefill: not "
                         "with stepwise=True or the hybrid and ssm families")
    with rec.span("serve/prefill_step",
                  tokens=int(tokens.shape[0] * tokens.shape[1])):
        if one_by_one:
            for t in range(tokens.shape[1]):
                logits, caches = T.forward(
                    model, cfg, tokens[:, t:t + 1], caches=caches,
                    cache_pos=t, enc_frames=enc_frames if t == 0 else None)
        else:
            logits, caches = T.forward(model, cfg, tokens, caches=caches,
                                       cache_pos=0, enc_frames=enc_frames,
                                       prefix_embeds=prefix_embeds)
    return logits[:, -1], caches


@torch.no_grad()
def decode_step(model, cfg: ArchConfig, last_token, caches, pos,
                enc_frames=None):
    """One token in, one token out; O(cache) attention / O(1) SSM state.
    last_token: (B, 1) integer; pos: an int or a (B,) tensor of per-row
    cursors (tokens already cached).  ``enc_frames``, where given, runs
    the encoder again and rewrites the cross-attention cache; without
    them the cached ``xk``/``xv`` are read."""
    rec = obs.current()
    with rec.span("serve/decode_step", batch=int(last_token.shape[0])):
        logits, caches = T.forward(model, cfg, last_token, caches=caches,
                                   cache_pos=pos, enc_frames=enc_frames)
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
