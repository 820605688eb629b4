"""GQA attention: full-sequence (direct or KV-chunked), cross, and decode.

PyTorch counterparts of the JAX package's ``models/attention.py``. With
``use_kernels`` the attention core goes to the CUDA kernels of
``repro_torch.kernels`` (their plain versions on CPU tensors). The decode
path writes the new token's K/V into the ring-buffer cache in place,
which saves a copy of the cache per layer and step; it returns the same
cache tensors it was given.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import common, sharding

NEG_INF = -2.0e38  # large-but-finite; avoids NaNs from (-inf) - (-inf)


@dataclasses.dataclass(frozen=True)
class AttnDims:
    num_heads: int
    num_kv_heads: int
    head_dim: int

    @property
    def q_groups(self) -> int:
        return self.num_heads // self.num_kv_heads


def dims_of(cfg) -> AttnDims:
    return AttnDims(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)


# ------------------------------------------------------------------ params
def init_attention(gen, cfg, d_model: int | None = None):
    """Weights in the JAX package's ``(in, out)`` layout: ``x @ w``."""
    d = d_model or cfg.d_model
    a = dims_of(cfg)
    dt = common.dtype_of(cfg)
    p = {
        "wq": common.dense_param(gen, (d, a.num_heads * a.head_dim), dt),
        "wk": common.dense_param(gen, (d, a.num_kv_heads * a.head_dim), dt),
        "wv": common.dense_param(gen, (d, a.num_kv_heads * a.head_dim), dt),
        "wo": common.dense_param(gen, (a.num_heads * a.head_dim, d), dt),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", a.num_heads), ("bk", a.num_kv_heads),
                            ("bv", a.num_kv_heads)):
            p[name] = torch.zeros((width * a.head_dim,), dtype=dt,
                                  device=gen.device)
    return p


def project_qkv(cfg, p, x):
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,K,hd)."""
    a = dims_of(cfg)
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = sharding.split_heads(q, a.num_heads, seq=True)
    k = sharding.split_heads(k, a.num_kv_heads)
    v = sharding.split_heads(v, a.num_kv_heads)
    return q, k, v


def _grouped(a, q, k, v):
    """q (B,S,H,hd) and k/v (B,T,K,hd) as the attention cores take them:
    q as (B,S,K,G,hd) (on a mesh, with G = 1 against K/V repeated to the
    H heads: ``sharding.repeat_kv``)."""
    B, S = q.shape[:2]
    q, k, v, g = sharding.repeat_kv(q, k, v, a.q_groups)
    return q.reshape(B, S, a.num_heads // g, g, a.head_dim), k, v


# ------------------------------------------------------------------ core SDPA
def _scores(q, k):
    """f32 scores (B,K,G,S,T) of q (B,S,K,G,hd) against k (B,T,K,hd), as
    the reference's product with ``preferred_element_type=f32``. On the
    card a low-precision q and k go to one bf16 x bf16 -> f32 ``bmm`` over
    the (batch, KV head) pairs (``out_dtype``): k is read in place where
    its storage is (B, K, T, hd), as ``encode_cross_kv`` lays out the
    cross K, and copied once in its own dtype otherwise. Elsewhere (the
    CPU build has no ``out_dtype`` kernel, and it has no derivative) both
    are widened to f32, which holds their products exactly."""
    if (q.device.type == "cuda" and q.dtype != torch.float32
            and k.dtype == q.dtype and not sharding.is_dtensor(q)
            and not (torch.is_grad_enabled()
                     and (q.requires_grad or k.requires_grad))):
        B, S, K, G, hd = q.shape
        T = k.shape[1]
        qm = q.permute(0, 2, 3, 1, 4).reshape(B * K, G * S, hd)
        km = k.permute(0, 2, 3, 1).reshape(B * K, hd, T)
        return torch.bmm(qm, km, out_dtype=torch.float32).view(B, K, G, S, T)
    return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())


def _direct_attention(q, k, v, bias, stats=False):
    """q: (B,S,K,G,hd); k,v: (B,T,K,hd); bias: broadcastable (B,1,1,S,T).

    f32 scores (``_scores``), f32 softmax, then p cast to ``v.dtype``
    before the PV product, as the reference does. ``stats``: also the
    softmax's row max and sum, each (B,K,G,S), for a merge with other
    keys' (``sharding.on_shards``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k)
    s = s * scale + bias
    if not stats:
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,btkd->bskgd", (e / l).to(v.dtype), v)
    return o, m[..., 0], l[..., 0]


def _chunked_attention(q, k, v, q_pos, k_pos, causal, window, chunk):
    """Flash-style online-softmax attention over KV chunks, f32 throughout.

    q: (B,S,K,G,hd); k/v: (B,T,K,hd); q_pos: (S,), k_pos: (T,).
    """
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, T, chunk):
        k_i, v_i = k[:, c0:c0 + chunk].float(), v[:, c0:c0 + chunk].float()
        kp_i = k_pos[c0:c0 + chunk]
        s = torch.einsum("bskgd,bckd->bkgsc", qf, k_i)
        ok = torch.ones((S, kp_i.shape[0]), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kp_i[None, :] <= q_pos[:, None]
        if window:
            ok &= kp_i[None, :] > (q_pos[:, None] - window)
        s = s.masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgsc,bckd->bkgsd", p, v_i)
        m = m_new
    o = acc / torch.clamp(l[..., None], min=1e-30)
    return o.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B,S,K,G,hd)


def self_attention(cfg, p, x, positions, *, causal=True, window=0,
                   attn_chunk=2048, use_kernels=False, return_kv=False,
                   seq_shard=None):
    """Full-sequence self attention. x: (B,S,d) -> (B,S,d).

    seq_shard: optional (batch axes, model axes) for sharding the QUERY
    sequence dim, with K/V replicated over it, as the reference's
    constraint (a no-op on plain tensors)."""
    a = dims_of(cfg)
    B, S, _ = x.shape
    q, k, v = project_qkv(cfg, p, x)
    if cfg.pos_emb == "rope":
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    if seq_shard is not None:
        batch_ax, model_ax = seq_shard[0], seq_shard[1]
        q = sharding.constrain(q, (batch_ax, model_ax, None, None))
        k = sharding.constrain(k, (batch_ax, None, None, None))
        v = sharding.constrain(v, (batch_ax, None, None, None))
    qg, kg, vg = _grouped(a, q, k, v)
    if use_kernels:
        o = fa.flash_attention(qg.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window)
    elif S <= max(attn_chunk, 2048) or S % attn_chunk != 0:
        bias = 0.0
        if causal or window:
            bias = common.causal_mask_bias(positions, positions,
                                           window if window else 0)
            bias = torch.clamp(bias, min=NEG_INF)[None, None, None]
        o = sharding.on_shards(_direct_attention, qg, kg, vg, bias,
                               seq_dims=(3,)).to(x.dtype)
    else:
        o = sharding.on_shards(_chunked_attention, qg, kg, vg, positions,
                               positions, causal, window, attn_chunk,
                               seq_dims=(0,))
    o = o.reshape(B, S, a.num_heads * a.head_dim)
    out = sharding.seq_matmul(o, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def cross_attention(cfg, p, x, enc_k, enc_v):
    """Decoder cross-attention against precomputed encoder K/V. The
    reference computes it with ``_direct_attention``, outside any Pallas
    kernel, so the port's is plain PyTorch too.

    x: (B, S, d); enc_k/enc_v: (B, T_enc, K, hd) -> (B, S, d)."""
    a = dims_of(cfg)
    B, S, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(B, S, a.num_kv_heads, a.q_groups, a.head_dim)
    o = sharding.on_shards(_direct_attention, q, enc_k, enc_v,
                           0.0).to(x.dtype)
    return o.reshape(B, S, a.num_heads * a.head_dim) @ p["wo"]


def encode_kv(cfg, p, enc_out):
    """Cross-attention K/V of the encoder output: (B, T_enc, K, hd) each."""
    a = dims_of(cfg)
    B, T, _ = enc_out.shape
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return (k.reshape(B, T, a.num_kv_heads, a.head_dim),
            v.reshape(B, T, a.num_kv_heads, a.head_dim))


# ------------------------------------------------------------------ decode
def decode_self_attention(cfg, p, x, cache_k, cache_v, pos, *, window=0,
                          use_kernels=False):
    """One-token decode. x: (B,1,d); cache_k/v: (B,T,K,hd) ring buffers.

    ``pos`` is the absolute position of the new token, a 0-d int32 tensor
    on x's device (the reference's traced scalar; a direct caller's int is
    taken as one): nothing here reads it on the host, so one captured
    step serves every position. Keys are
    stored rope-applied at absolute positions, so ring-buffer reuse is
    correct without rope recomputation. The new K/V go into slot
    ``pos % T`` in place. Returns (out, cache_k, cache_v).
    """
    a = dims_of(cfg)
    B = x.shape[0]
    T = cache_k.shape[1]
    pos = common.position(pos, x)
    q, k, v = project_qkv(cfg, p, x)  # (B,1,H,hd), (B,1,K,hd)
    if cfg.pos_emb == "rope":
        ppos = pos.view(1)
        q = common.apply_rope(q, ppos, cfg.rope_theta)
        k = common.apply_rope(k, ppos, cfg.rope_theta)
    slot = pos % T
    cache_k = sharding.write_slot(cache_k, slot, k[:, 0].to(cache_k.dtype))
    cache_v = sharding.write_slot(cache_v, slot, v[:, 0].to(cache_v.dtype))
    # the reference's where(pos >= T, all, idx <= pos): past a full ring
    # every idx < T <= pos, so idx <= pos alone is that mask
    valid = torch.arange(T, device=x.device) <= pos
    # quantized caches (e.g. fp8) are converted after the read
    kr = cache_k if cache_k.dtype == x.dtype else cache_k.to(x.dtype)
    vr = cache_v if cache_v.dtype == x.dtype else cache_v.to(x.dtype)
    qg, kr, vr = _grouped(a, q, kr, vr)
    if use_kernels:
        o = da.decode_attention(qg.contiguous(), kr, vr, valid)
    else:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        bias = torch.where(valid, zero, NEG_INF)[None, None, None, None, :]
        o = sharding.on_shards(_direct_attention, qg, kr, vr, bias,
                               key_dims=(4,)).to(x.dtype)
    o = o.reshape(B, 1, a.num_heads * a.head_dim)
    return o @ p["wo"], cache_k, cache_v
