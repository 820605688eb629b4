"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Attention appears once every 8 layers (offset 4 per the paper's block
layout); MoE replaces the FFN every 2 layers (odd layers).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887 (Jamba v0.1)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, experts_per_token=2, every=2, first_dense=1),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, n_groups=1),
    attn_period=8,
    attn_offset=4,
    norm="rmsnorm",
    act="silu",
)
