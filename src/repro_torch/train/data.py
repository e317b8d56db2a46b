"""Data pipeline (port of ``repro/train/data.py``): deterministic
synthetic token streams (per-shard seeded, restart-reproducible) plus a
byte-level corpus reader.  Host numpy, the reference's ``SeedSequence``
streams; `batches` puts each batch on the device.

Each data shard derives its stream from (global step, shard index) alone:
no coordination, elastic by construction: resharding after a failure only
changes the (deterministic) assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.csr import resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus_path: Optional[str] = None


def synthetic_tokens(step: int, shard: int, n_shards: int,
                     cfg: DataConfig) -> np.ndarray:
    """(local_batch, seq_len+1) int32: a Markov-ish stream so loss can
    actually fall (token t+1 depends on token t)."""
    local = cfg.global_batch // n_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))
    base = rng.integers(0, cfg.vocab, (local, 1))
    steps = rng.integers(1, 17, (local, cfg.seq_len))
    toks = (np.cumsum(np.concatenate([base, steps], 1), axis=1)) % cfg.vocab
    return toks.astype(np.int32)


class CorpusReader:
    """Byte-level corpus from a local file with deterministic random
    access (vocab ≤ 256+)."""

    def __init__(self, path: str, cfg: DataConfig):
        with open(path, "rb") as f:
            self.data = np.frombuffer(f.read(), dtype=np.uint8)
        self.cfg = cfg

    def batch(self, step: int, shard: int, n_shards: int) -> np.ndarray:
        cfg = self.cfg
        local = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard, 7]))
        max_start = max(1, len(self.data) - cfg.seq_len - 2)
        starts = rng.integers(0, max_start, local)
        rows = [self.data[s:s + cfg.seq_len + 1] for s in starts]
        return np.stack(rows).astype(np.int32) % cfg.vocab


def batches(cfg: DataConfig, shard: int = 0, n_shards: int = 1,
            start_step: int = 0, device=None) -> Iterator[dict]:
    """``{"tokens": (local_batch, seq_len+1) int64}`` on ``device`` (None
    = CUDA; raises without a card unless ``device="cpu"``), one batch per
    step from ``start_step``."""
    dev = resolve_device(device)
    reader = CorpusReader(cfg.corpus_path, cfg) if cfg.corpus_path else None
    step = start_step
    while True:
        if reader is not None:
            toks = reader.batch(step, shard, n_shards)
        else:
            toks = synthetic_tokens(step, shard, n_shards, cfg)
        yield {"tokens": torch.from_numpy(toks.astype(np.int64)).to(dev)}
        step += 1
