"""Layer-stack machinery: the per-layer block kinds and the loops over them.

The JAX package factors the layer kinds into an unrolled prefix plus a
``lax.scan`` over stacked periods; the port keeps one parameter dict per
layer in ``params["layers"]`` and loops over them. ``stack_pattern`` is
kept (pure Python) because the weight bridge unstacks the JAX periods by
it. A BlockKind is the static tuple ``(mixer, ffn, d_ff)`` with mixer in
{'attn','ssm'}, ffn in {'dense','moe','none'}.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import (attention, common, ffn as ffn_mod, sharding,
                                ssm as ssm_mod)


@dataclasses.dataclass(frozen=True)
class CallOpts:
    """Runtime (non-architecture) options for a model call.

    The same fields and defaults as the JAX package's ``CallOpts``. The
    sharding hints (``logits_spec``, ``act_spec``, ``attn_seq_shard``)
    redistribute a DTensor where the reference constrains its sharding
    (``sharding.constrain``) and leave a plain tensor alone. ``remat``
    checkpoints each block of the stacked periods in a full-sequence pass
    without a cache (the train step's): ``torch.utils.checkpoint`` keeps
    the block's input and recomputes the rest in the backward, as
    ``jax.checkpoint`` on the reference's scanned period body; the
    unrolled prefix (deepseek's dense first layer) is not checkpointed,
    as the reference's is not. Prefill and decode never remat."""
    use_kernels: bool = False
    attn_chunk: int = 4096
    capacity_factor: float = 1.25
    window: int = 0  # sliding-window override for self-attention (0 = full)
    remat: bool = False
    logits_spec: tuple = None
    act_spec: tuple = None
    cache_dtype: str = "bfloat16"
    attn_seq_shard: tuple = None
    moe_single_group_decode: bool = False


# ------------------------------------------------------------------ pattern
def layer_kinds(cfg):
    kinds = []
    for i in range(cfg.num_layers):
        mixer = cfg.layer_kind(i)
        if mixer == "ssm" and cfg.family == "ssm":
            kinds.append((mixer, "none", 0))
            continue
        f = cfg.ffn_kind(i)
        dff = cfg.d_ff
        if (f == "dense" and cfg.moe is not None
                and i < cfg.moe.first_dense and cfg.moe.d_ff_dense):
            dff = cfg.moe.d_ff_dense
        kinds.append((mixer, f, dff))
    return kinds


def stack_pattern(cfg):
    """-> (prefix_kinds, period_kinds, n_periods), as the JAX package."""
    kinds = layer_kinds(cfg)
    L = len(kinds)
    best = None  # (period_len, prefix_len, prefix, period, n)
    for prefix in range(0, min(L, 4)):
        rest = kinds[prefix:]
        n = len(rest)
        if n == 0:
            continue
        for p in range(1, n + 1):
            if n % p == 0 and rest == rest[:p] * (n // p):
                cand = (p, prefix, tuple(kinds[:prefix]), tuple(rest[:p]), n // p)
                if best is None or (cand[0], cand[1]) < (best[0], best[1]):
                    best = cand
                break  # smallest period for this prefix
    _, _, prefix_kinds, period_kinds, n_periods = best
    return prefix_kinds, period_kinds, n_periods


# ------------------------------------------------------------------ init
def init_block(gen, cfg, kind):
    mixer, f, dff = kind
    p = {"ln1": common.init_norm(cfg, cfg.d_model, gen.device)}
    if mixer == "attn":
        p["attn"] = attention.init_attention(gen, cfg)
    else:
        p["ssm"] = ssm_mod.init_ssm(gen, cfg)
    if f == "dense":
        p["ln2"] = common.init_norm(cfg, cfg.d_model, gen.device)
        p["ffn"] = ffn_mod.init_dense_ffn(gen, cfg, d_ff=dff)
    elif f == "moe":
        p["ln2"] = common.init_norm(cfg, cfg.d_model, gen.device)
        p["moe"] = ffn_mod.init_moe(gen, cfg)
    return p


def init_layers(gen, cfg):
    return [init_block(gen, cfg, kind) for kind in layer_kinds(cfg)]


# ------------------------------------------------------------------ cache
def init_block_cache(cfg, kind, batch, kv_len, dtype, device):
    if kind[0] == "attn":
        a = attention.dims_of(cfg)
        shape = (batch, kv_len, a.num_kv_heads, a.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    s = cfg.ssm
    _, nh, conv_ch = ssm_mod.ssm_dims(cfg)
    return {"conv": torch.zeros((batch, s.conv_width - 1, conv_ch),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=device)}


def init_stack_cache(cfg, batch, kv_len, dtype, device):
    return [init_block_cache(cfg, kind, batch, kv_len, dtype, device)
            for kind in layer_kinds(cfg)]


def _kv_into_ring(k, kv_len):
    """Place full-prefill K (B,S,...) into a ring buffer of length kv_len."""
    B, S = k.shape[:2]
    if S <= kv_len:
        buf = k.new_zeros((B, kv_len) + tuple(k.shape[2:]))
        buf[:, :S] = k
        return buf
    tail = k[:, -kv_len:]
    return torch.roll(tail, shifts=(S - kv_len) % kv_len, dims=1)


# ------------------------------------------------------------------ apply
def apply_block_full(cfg, kind, p, h, positions, opts: CallOpts,
                     kv_len: Optional[int] = None):
    """Full-sequence block. Returns (h, aux_loss, cache_entry_or_None)."""
    mixer, f, _ = kind
    p = sharding.gather_fsdp(p, like=h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    cache_entry = None
    hn = common.apply_norm(cfg, p["ln1"], h)
    if mixer == "attn":
        o = attention.self_attention(
            cfg, p["attn"], hn, positions, window=opts.window,
            attn_chunk=opts.attn_chunk, use_kernels=opts.use_kernels,
            return_kv=kv_len is not None, seq_shard=opts.attn_seq_shard)
        if kv_len is not None:
            o, (k, v) = o
            cache_entry = {"k": _kv_into_ring(k, kv_len),
                           "v": _kv_into_ring(v, kv_len)}
    else:
        o = ssm_mod.ssd_forward(cfg, p["ssm"], hn,
                                return_state=kv_len is not None,
                                use_kernels=opts.use_kernels)
        if kv_len is not None:
            o, (conv_tail, state) = o
            cache_entry = {"conv": conv_tail, "state": state}
    h = h + o
    if f == "dense":
        h = h + ffn_mod.dense_ffn(cfg, p["ffn"],
                                  common.apply_norm(cfg, p["ln2"], h))
    elif f == "moe":
        y, aux = ffn_mod.moe_ffn(cfg, p["moe"],
                                 common.apply_norm(cfg, p["ln2"], h),
                                 capacity_factor=opts.capacity_factor,
                                 use_kernels=opts.use_kernels)
        h = h + y
    return sharding.constrain(h, opts.act_spec), aux, cache_entry


def apply_block_decode(cfg, kind, p, h, cache_entry, pos, opts: CallOpts):
    """One-token decode block. Returns (h, cache_entry): an attention entry
    is updated in place, an SSM entry is replaced. ``pos`` (a 0-d int32
    tensor) is ignored by SSM blocks."""
    mixer, f, _ = kind
    p = sharding.gather_fsdp(p, like=h)
    hn = common.apply_norm(cfg, p["ln1"], h)
    if mixer == "attn":
        o, nk, nv = attention.decode_self_attention(
            cfg, p["attn"], hn, cache_entry["k"], cache_entry["v"], pos,
            window=opts.window, use_kernels=opts.use_kernels)
        new_entry = {"k": nk, "v": nv}
    else:
        o, nconv, nstate = ssm_mod.ssd_decode_step(
            cfg, p["ssm"], hn, cache_entry["conv"], cache_entry["state"])
        new_entry = {"conv": nconv, "state": nstate}
    h = h + o
    if f == "dense":
        h = h + ffn_mod.dense_ffn(cfg, p["ffn"],
                                  common.apply_norm(cfg, p["ln2"], h))
    elif f == "moe":
        # the reference's decode capacity factor, whatever opts say
        y, _ = ffn_mod.moe_ffn(cfg, p["moe"],
                               common.apply_norm(cfg, p["ln2"], h),
                               capacity_factor=2.0,
                               use_kernels=opts.use_kernels,
                               single_group=opts.moe_single_group_decode)
        h = h + y
    return sharding.constrain(h, opts.act_spec), new_entry


# ------------------------------------------------------------------ stack
def apply_stack(cfg, layers, h, positions, opts: CallOpts,
                kv_len: Optional[int] = None):
    """Full-sequence stack. Returns (h, aux_total, cache_or_None)."""
    h = sharding.constrain(h, opts.act_spec)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    cache = []
    # the reference checkpoints its scanned period body, not the prefix
    remat_from = (len(stack_pattern(cfg)[0]) if opts.remat and kv_len is None
                  else len(layers))
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), layers)):
        if i >= remat_from:
            h, aux, ce = checkpoint(apply_block_full, cfg, kind, p, h,
                                    positions, opts, use_reentrant=False)
        else:
            h, aux, ce = apply_block_full(cfg, kind, p, h, positions, opts,
                                          kv_len)
        aux_total = aux_total + aux
        cache.append(ce)
    return h, aux_total, (cache if kv_len is not None else None)


def decode_stack(cfg, layers, h, pos, cache, opts: CallOpts):
    """One-token decode through the stack. Returns (h, new_cache)."""
    new_cache = []
    for kind, p, ce in zip(layer_kinds(cfg), layers, cache):
        h, nce = apply_block_decode(cfg, kind, p, h, ce, pos, opts)
        new_cache.append(nce)
    return h, new_cache
