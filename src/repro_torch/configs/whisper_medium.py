"""whisper-medium [audio]: enc-dec backbone; conv frontend is a STUB —
input_specs provides precomputed (B, 1500, d) frame embeddings
[arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    enc_layers=24, enc_positions=1500, tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)
