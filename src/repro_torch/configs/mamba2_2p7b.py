"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060].

64L d_model=2560, attention-free, d_ff=0, vocab=50280, ssm_state=128.
Mamba2 block: expand=2 -> d_inner=5120, head_dim=64 -> 80 SSD heads.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060 (Mamba2 SSD), mamba2-2.7b model card",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=8, conv_width=4),
    norm="rmsnorm",
    tie_embeddings=True,
)
