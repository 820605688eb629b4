"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066].

28L d_model=2048 16H (kv=16) d_ff=1408 (per-expert) vocab=102400.
First layer uses a dense FFN (d_ff 10944) per the paper.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066 (DeepSeekMoE 16B)",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(
        num_experts=64,
        experts_per_token=6,
        num_shared_experts=2,
        first_dense=1,
        d_ff_dense=10944,
    ),
    norm="rmsnorm",
    act="silu",
    long_context_window=8192,
)
