"""Architecture and input-shape configuration dataclasses.

Every assigned architecture is expressed as an ``ArchConfig``; the four
assigned input shapes are ``ShapeConfig``s. Full configs are exercised only
via the dry-run (ShapeDtypeStruct, no allocation); smoke tests use
``reduced()`` variants.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    num_shared_experts: int = 0
    # Apply MoE every `every` layers (1 = every layer). Jamba: every 2.
    every: int = 1
    # Number of leading layers that use a dense FFN instead (deepseek-moe: 1).
    first_dense: int = 0
    # Dense-FFN hidden size for `first_dense` layers (0 -> use arch d_ff).
    d_ff_dense: int = 0
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba/Mamba2 (SSD) block configuration."""
    d_state: int
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 8  # B/C projection groups (shardable analogue of GQA)
    conv_width: int = 4
    chunk_size: int = 256  # SSD chunked scan block size

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str  # citation for the config values
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Hybrid interleave: attention appears once per `attn_period` layers at
    # offset `attn_offset`; all other layers are SSM blocks. 0 = not hybrid.
    attn_period: int = 0
    attn_offset: int = 0
    # Attention details
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    act: str = "silu"  # silu -> SwiGLU, gelu -> GeGLU, gelu_plain -> plain MLP
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"  # rope | learned
    max_learned_pos: int = 32_768  # table size when pos_emb == "learned"
    tie_embeddings: bool = False
    # Encoder-decoder (whisper): encoder consumes stubbed frame embeddings.
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0
    # VLM: number of stubbed visual-patch embedding tokens prepended to text.
    num_visual_tokens: int = 0
    # Window used for the long_500k sliding-window variant on full-attention
    # archs (0 = arch is natively sub-quadratic or long_500k is skipped).
    long_context_window: int = 0
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    # ---- derived ----
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for layer i of the mixer stack."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_period:
            return "attn" if i % self.attn_period == self.attn_offset else "ssm"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'moe' or 'dense' for layer i."""
        if self.moe is None:
            return "dense"
        if i < self.moe.first_dense:
            return "dense"
        if (i - self.moe.first_dense) % self.moe.every == 0:
            return "moe"
        return "dense"

    @functools.lru_cache(maxsize=None)
    def param_count(self) -> int:
        """Approximate total parameter count (embeddings included).

        Memoized (the config is frozen): the perf model and RaPP feature
        extraction evaluate this in per-event hot loops."""
        d, f = self.d_model, self.d_ff
        hd = self.head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        if self.act in ("silu", "gelu"):
            ffn_dense = 3 * d * f
        else:
            ffn_dense = 2 * d * f
        total = 0
        for i in range(self.num_layers):
            if self.layer_kind(i) == "attn":
                total += attn
            else:
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                # in_proj (z,x,B,C,dt) + conv + out_proj
                total += d * (2 * di + 2 * s.n_groups * s.d_state + nh) \
                    + s.conv_width * (di + 2 * s.n_groups * s.d_state) \
                    + di * d + 2 * nh
            kind = self.ffn_kind(i)
            if self.family == "ssm":
                pass  # mamba2 has no separate FFN
            elif kind == "moe":
                m = self.moe
                fe = f
                total += (m.num_experts + m.num_shared_experts) * 3 * d * fe
                total += d * m.num_experts  # router
            else:
                fd = (self.moe.d_ff_dense or f) if (self.moe and self.ffn_kind(i) == "dense" and self.moe.first_dense and i < self.moe.first_dense) else f
                total += 3 * d * fd if self.act in ("silu", "gelu") else 2 * d * fd
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_encoder_decoder:
            total += self.encoder_layers * (attn + (2 * d * f if self.act == "gelu_plain" else 3 * d * f))
            total += self.num_layers * attn  # cross-attention
        return total

    @functools.lru_cache(maxsize=None)
    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        m, d, f = self.moe, self.d_model, self.d_ff
        n_moe_layers = sum(1 for i in range(self.num_layers) if self.ffn_kind(i) == "moe")
        inactive = n_moe_layers * (m.num_experts - m.experts_per_token) * 3 * d * f
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests.

    2 layers, d_model<=512, <=4 experts, small vocab — per assignment spec.
    """
    d_model = min(cfg.d_model, 256)
    num_heads = min(cfg.num_heads, 4)
    ratio = max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1)
    num_kv_heads = max(num_heads // ratio, 1)
    updates = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        head_dim=64,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_visual_tokens=min(cfg.num_visual_tokens, 16),
    )
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            first_dense=min(cfg.moe.first_dense, 1),
            d_ff_dense=min(cfg.moe.d_ff_dense, 512) if cfg.moe.d_ff_dense else 0,
        )
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=min(cfg.ssm.d_state, 64), n_groups=1,
            head_dim=32, chunk_size=64,
        )
    if cfg.attn_period:
        # keep the hybrid interleave visible in 2 layers: 1 ssm + 1 attn
        updates["attn_period"] = 2
        updates["attn_offset"] = 1
    if cfg.is_encoder_decoder:
        updates["encoder_layers"] = 2
        updates["encoder_seq"] = min(cfg.encoder_seq, 64)
    if cfg.long_context_window:
        updates["long_context_window"] = 64
    return dataclasses.replace(cfg, **updates)
