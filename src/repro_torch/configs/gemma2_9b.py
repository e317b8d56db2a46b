"""gemma2-9b [dense]: local(4096)/global alternating attention, logit
softcaps, post-norms [arXiv:2408.00118; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab=256000, head_dim=256,
    window=4096, local_global_alternate=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    source="arXiv:2408.00118; hf",
)
