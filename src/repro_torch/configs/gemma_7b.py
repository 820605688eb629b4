"""gemma-7b — GeGLU, head_dim=256 [arXiv:2403.08295].

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    source="arXiv:2403.08295 (Gemma 7B)",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    norm="rmsnorm",
    act="gelu",  # GeGLU
    tie_embeddings=True,
    long_context_window=8192,
)
