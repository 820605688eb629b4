"""dbrx-132b — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    moe=MoEConfig(num_experts=16, experts_per_token=4),
    norm="layernorm",
    act="silu",
    rope_theta=500_000.0,
    long_context_window=8192,
)
