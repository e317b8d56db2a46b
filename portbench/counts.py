"""Operations and bytes, worked out from shapes alone.

``forward_flops``: the model FLOPs of one forward, 2 per multiply-add of
every weight matrix a token passes through (the head over the published
vocabulary, not its padding) plus the causal attention's scores and
values (2·hd FLOPs per key each, for the L(L+1)/2 query-key pairs of a
sequence).  The depthwise conv, the norms, the softmax and the SSD scan
are left out: a share of a peak counted from these can only read low.

``ssd_scan_*``: the Mamba2 scan's call at its shape (BH rows of L steps,
heads of P channels, state N, groups of heads sharing B and C), copied
from ``chip_smoke.ssd_bound``'s byte count: inputs read once and the
output written once, in float32.  Its operations are the exact
recurrence's, 5·N·P per row and step (h ← a·h + b·xᵀ, y = C·h), at the
fastest rate a float32-input product has on the card (TF32 tensor
cores), so the byte term binds at the model's shapes.  Both depend on the
shape only, never on the chunk size or the number of launches.
"""
from __future__ import annotations


def _attn_proj(cfg: dict) -> int:
    d = cfg["d_model"]
    hd = d // cfg["n_heads"]
    return d * cfg["n_heads"] * hd * 2 + 2 * d * cfg["n_kv_heads"] * hd


def _mlp(cfg: dict) -> int:
    return 3 * cfg["d_model"] * cfg["d_ff"]


def _mamba(cfg: dict) -> int:
    d, n = cfg["d_model"], cfg["ssm_state"]
    di = cfg["ssm_expand"] * d
    nh = di // cfg["ssm_head_dim"]
    return d * (2 * di + 2 * n + nh) + di * d


def attention_flops(cfg: dict, seq: int) -> int:
    """Scores and values of one sequence through one attention layer."""
    return 2 * 2 * cfg["d_model"] * (seq * (seq + 1) // 2)


def forward_flops(cfg: dict, batch: int, seq: int) -> int:
    tokens = batch * seq
    head = cfg["d_model"] * cfg["vocab"]
    if cfg["family"] == "dense":
        layers = cfg["n_layers"]
        weights = layers * (_attn_proj(cfg) + _mlp(cfg)) + head
    elif cfg["family"] == "hybrid":
        layers = cfg["n_layers"] // cfg["attn_every"]
        weights = (cfg["n_layers"] * _mamba(cfg)
                   + layers * (_attn_proj(cfg) + _mlp(cfg)) + head)
    else:
        raise ValueError(f"no FLOP count for family {cfg['family']!r}")
    return 2 * weights * tokens + layers * batch * attention_flops(cfg, seq)


def train_step_flops(cfg: dict, batch: int, seq: int) -> int:
    """Forward and backward, 3× the forward; recomputation not counted."""
    return 3 * forward_flops(cfg, batch, seq)


def ssd_scan_bytes(bh: int, l: int, p: int, n: int, groups: int) -> int:
    return 4 * (2 * bh * l * p + bh * l + 2 * groups * l * n)


def ssd_scan_flops(bh: int, l: int, p: int, n: int) -> int:
    return 5 * bh * l * n * p


def ssd_scan_least_s(bh, l, p, n, groups, peak: dict) -> tuple:
    """(seconds, "bytes" or "operations"): the least time of one call."""
    t_bytes = ssd_scan_bytes(bh, l, p, n, groups) / peak["hbm_bytes_per_s"]
    t_ops = ssd_scan_flops(bh, l, p, n) / peak["tf32_flops_per_s"]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
