"""Plain PyTorch versions of the attention kernels (the allclose targets).

Same layouts and arithmetic as the JAX package's ``kernels/ref.py``:
f32 scores and softmax, masked entries at -inf, output cast back to q's
dtype. The kernel wrappers run these on CPU tensors.
"""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B,S,K,G,hd); k,v: (B,T,K,hd) -> (B,S,K,G,hd). f32 softmax."""
    S, hd = q.shape[1], q.shape[-1]
    T = k.shape[1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.to(q.dtype)


def decode_attention_ref(q, k, v, valid):
    """q: (B,1,K,G,hd); k,v: (B,T,K,hd); valid: (T,) bool -> (B,1,K,G,hd)."""
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.to(q.dtype)
