"""olmo-1b — non-parametric LayerNorm [arXiv:2402.00838].

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    source="arXiv:2402.00838 (OLMo 1B)",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric_ln",
    act="silu",
    tie_embeddings=True,
    long_context_window=8192,
)
