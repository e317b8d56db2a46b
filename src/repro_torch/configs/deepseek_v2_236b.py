"""deepseek-v2-236b [moe]: MLA (kv_lora=512) + 2 shared + 160 routed top-6
experts [arXiv:2405.04434; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102400,
    n_experts=160, n_shared_experts=2, top_k=6, d_ff_expert=1536,
    kv_lora=512, q_lora=1536, rope_head_dim=64, nope_head_dim=128,
    v_head_dim=128, tie_embeddings=False,
    source="arXiv:2405.04434; hf",
)
