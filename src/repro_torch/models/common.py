"""Shared building blocks: norms, activations, rotary embeddings, init.

PyTorch counterparts of the JAX package's ``models/common.py``. Init draws
from an explicit ``torch.Generator`` in the same distributions (it cannot
give jax.random's numbers; parity tests carry weights across instead).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.models import sharding


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------- init
def dense_param(gen, shape, dtype, in_axis: int = 0):
    """Truncated-normal fan-in init on ``gen``'s device."""
    fan_in = shape[in_axis] if in_axis < len(shape) else shape[0]
    std = 1.0 / np.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if isinstance(t, FakeTensor):   # shape only (RaPP's graph extractor)
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def embed_param(gen, shape, dtype):
    t = torch.randn(shape, dtype=torch.float32, device=gen.device,
                    generator=gen)
    return t.mul_(0.02).to(dtype)   # in place: one f32 copy at a time


# ---------------------------------------------------------------- norms
def init_norm(cfg, d: int, device):
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "nonparametric_ln":
        return {}
    raise ValueError(cfg.norm)


def apply_norm(cfg, p, x, eps: float = 1e-5):
    """Norms run in f32 and cast back; the variance is the population
    variance (``correction=0``), as ``jnp.var``. A DTensor holding partial
    sums (a row-parallel product's output) is reduced first, a norm not
    being linear in them, and its feature dim gathered."""
    x = sharding.reduce_partial(x)
    dt = x.dtype
    x = x.float()
    if cfg.norm == "rmsnorm":
        x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
        x = x * p["scale"]
    else:  # layernorm / nonparametric_ln
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        x = (x - mu) * torch.rsqrt(var + eps)
        if cfg.norm == "layernorm":
            x = x * p["scale"] + p["bias"]
    return x.to(dt)


# ---------------------------------------------------------------- activations
def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    if name in ("silu",):
        return F.silu
    if name in ("gelu", "gelu_plain"):
        return _gelu_tanh
    raise ValueError(name)


# ---------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=16)
def _freqs_on(head_dim: int, theta: float, device: torch.device):
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def _freqs_for(x, head_dim: int, theta: float):
    """The rotary frequencies on ``x``'s device: cached for real tensors,
    made anew for a fake or meta one or under a FakeTensorMode (a
    shape-only trace, of DTensors too), which must never be cached nor be
    handed a cached tensor."""
    if (x.is_meta or isinstance(x, FakeTensor) or torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None):
        return torch.from_numpy(rope_freqs(head_dim, theta)).to(x.device)
    return _freqs_on(head_dim, theta, x.device)


def apply_rope(x, positions, theta: float):
    """Split-half rotary embedding in f32. x: (..., seq, heads, head_dim);
    positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = _freqs_for(x, hd, float(theta))                      # (hd/2,)
    angles = positions[..., :, None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def position(pos, like):
    """A decode step's absolute position as the reference passes it: a
    0-d int32 tensor, here on ``like``'s device. A Python int is converted
    (the one place it is); a tensor there already is taken as it is."""
    return torch.as_tensor(pos, dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------- misc
def causal_mask_bias(q_pos, k_pos, window: int = 0):
    """Additive bias (0 / -inf) for causal (+ optional sliding window) masking.

    q_pos: (..., S_q), k_pos: (..., S_k) -> (..., S_q, S_k)
    """
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window:
        ok &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, float("-inf"))

