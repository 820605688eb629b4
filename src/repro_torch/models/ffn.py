"""Dense feed-forward layers (gated or plain MLP).

PyTorch counterparts of the JAX package's ``init_dense_ffn``/``dense_ffn``.
The MoE layer arrives with the port of the grouped-matmul kernel.
"""
from __future__ import annotations

import torch

from repro_torch.models import common


def init_dense_ffn(gen, cfg, d_ff: int | None = None):
    """Weights in the JAX package's ``(in, out)`` layout: ``x @ w``."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = common.dtype_of(cfg)
    if cfg.act == "gelu_plain":
        return {"w_in": common.dense_param(gen, (d, f), dt),
                "b_in": torch.zeros((f,), dtype=dt, device=gen.device),
                "w_out": common.dense_param(gen, (f, d), dt),
                "b_out": torch.zeros((d,), dtype=dt, device=gen.device)}
    return {"w_gate": common.dense_param(gen, (d, f), dt),
            "w_up": common.dense_param(gen, (d, f), dt),
            "w_down": common.dense_param(gen, (f, d), dt)}


def dense_ffn(cfg, p, x):
    act = common.activation(cfg.act)
    if cfg.act == "gelu_plain":
        return act(x @ p["w_in"] + p["b_in"]) @ p["w_out"] + p["b_out"]
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
