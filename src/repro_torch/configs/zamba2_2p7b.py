"""zamba2-2.7b [hybrid]: Mamba2 backbone + ONE weight-shared attention block
applied every 6 layers [arXiv:2411.15242; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    attn_every=6, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    source="arXiv:2411.15242; hf",
)
