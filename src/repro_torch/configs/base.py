"""Architecture configs: one frozen dataclass drives every model family
(a copy of ``repro/configs/base.py`` without its jax import).

Each assigned architecture gets a module ``configs/<id>.py`` exporting
``CONFIG`` (the exact published shape) — ``reduced()`` derives the smoke-test
version (same family/topology, tiny dims).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    mlp_gelu: bool = False            # 2-matrix GELU MLP (starcoder2)
    # attention flavour
    rope_theta: float = 10_000.0
    window: Optional[int] = None              # sliding-window size
    local_global_alternate: bool = False      # gemma2: even layers local
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    # hybrid (zamba2): one weight-shared attention block every `attn_every`
    attn_every: int = 0
    # ssm (mamba2 / rwkv6)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    rwkv: bool = False
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: Optional[int] = None
    capacity_factor: float = 1.25
    # mla (deepseek)
    kv_lora: int = 0
    q_lora: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_positions: int = 1500                 # stubbed frame count
    # modality frontend stub (vlm/audio): prefix embeddings fed directly
    n_prefix_embeds: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    source: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def vocab_pad(self) -> int:
        """Vocab rounded to 512 so the embedding shards on any mesh axis
        (the standard padded-vocab trick; logits beyond vocab are unused)."""
        return ((self.vocab + 511) // 512) * 512

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §4)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm" and self.rwkv:
            # rwkv6: time-mix (r,k,v,g,o) 5·d² + cm receptance d² + channel-mix
            per_layer = 6 * d * d + 2 * d * self.d_ff
        elif self.family in ("hybrid",):
            di = self.d_inner
            n = self.ssm_state
            mamba = (d * (2 * di + 2 * n * 1 + self.ssm_nheads)  # in_proj(zx)+BC+dt
                     + di * d)                                    # out_proj
            # ONE weight-shared attention+MLP block for the whole stack
            shared = 4 * d * d + 3 * d * self.d_ff
            return int(emb + self.n_layers * mamba + shared)
        else:
            if self.is_mla:
                qk = self.nope_head_dim + self.rope_head_dim
                attn = (d * self.q_lora + self.q_lora * self.n_heads * qk
                        + d * (self.kv_lora + self.rope_head_dim)
                        + self.kv_lora * self.n_heads
                        * (self.nope_head_dim + self.v_head_dim)
                        + self.n_heads * self.v_head_dim * d)
            else:
                attn = (d * self.n_heads * self.hd
                        + 2 * d * self.n_kv_heads * self.hd
                        + self.n_heads * self.hd * d)
            nmat = 2 if self.mlp_gelu else 3
            if self.is_moe:
                dff = self.d_ff_expert or self.d_ff
                ffn = (self.n_experts + self.n_shared_experts) * nmat * d * dff \
                    + d * self.n_experts
            else:
                ffn = nmat * d * self.d_ff
            per_layer = attn + ffn
        total = emb + (self.n_layers + self.enc_layers) * per_layer
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k count)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dff = self.d_ff_expert or self.d_ff
        inert = (self.n_experts - self.top_k) * 3 * d * dff * self.n_layers
        return self.param_count() - int(inert)

    def reduced(self) -> "ArchConfig":
        """Smoke-test config: same wiring, tiny dims."""
        return dataclasses.replace(
            self,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4
                                  // max(self.n_heads, 1)) or 1),
            d_ff=128,
            head_dim=16 if self.head_dim is not None else None,
            vocab=256,
            window=min(self.window, 32) if self.window else None,
            attn_every=2 if self.attn_every else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32,
            n_experts=min(8, self.n_experts) if self.is_moe else 0,
            n_shared_experts=min(1, self.n_shared_experts),
            top_k=min(2, self.top_k) if self.is_moe else 0,
            d_ff_expert=64 if self.d_ff_expert else None,
            kv_lora=32 if self.kv_lora else 0,
            q_lora=48 if self.q_lora else 0,
            rope_head_dim=8 if self.kv_lora else 64,
            nope_head_dim=16 if self.kv_lora else 128,
            v_head_dim=16 if self.kv_lora else 128,
            enc_layers=2 if self.enc_layers else 0,
            enc_positions=32 if self.enc_layers else 1500,
            n_prefix_embeds=min(8, self.n_prefix_embeds),
        )


# shape grid (assignment): every LM arch gets these four cells
SHAPES = {
    "train_4k":    dict(seq_len=4096,    global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768,   global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32768,   global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524288,  global_batch=1,   kind="decode"),
}

ARCH_IDS = [
    "zamba2_2p7b", "whisper_medium", "internvl2_26b", "starcoder2_15b",
    "mistral_large_123b", "gemma2_9b", "minicpm_2b", "rwkv6_7b",
    "deepseek_v2_236b", "llama4_scout_17b_a16e",
]


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def cell_is_applicable(cfg: ArchConfig, shape_name: str) -> Tuple[bool, str]:
    """Whether (arch × shape) runs, per the assignment's skip rules."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; " \
                      f"{cfg.name} is full-attention (DESIGN.md §4)"
    return True, ""
