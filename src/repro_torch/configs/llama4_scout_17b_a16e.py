"""llama4-scout-17b-a16e [moe]: 16 experts top-1 + shared expert; early
fusion is a stub (text tokens only)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    n_experts=16, n_shared_experts=1, top_k=1, d_ff_expert=8192,
    tie_embeddings=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
