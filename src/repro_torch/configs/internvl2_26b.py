"""internvl2-26b [vlm]: InternViT frontend STUB (256 patch embeddings prefix)
+ InternLM2-20B-like dense GQA backbone [arXiv:2404.16821; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553,
    n_prefix_embeds=256, tie_embeddings=False,
    source="arXiv:2404.16821; hf",
)
