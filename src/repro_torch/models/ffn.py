"""Feed-forward layers: gated dense FFN and the einsum-dispatch MoE.

PyTorch counterparts of the JAX package's ``models/ffn.py``. The MoE
keeps the reference's fixed-capacity one-hot dispatch: tokens are routed
within groups (a batch row, or the whole batch for single-group decode)
and dispatched/combined with einsums; the expert FFN is the grouped
matmul of ``kernels/moe_gmm.py`` when ``use_kernels`` is set.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import moe_gmm, ref
from repro_torch.models import common, sharding


# ------------------------------------------------------------------ dense
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
    hidden = act(x @ p["w_gate"]) * (x @ p["w_up"])
    return sharding.summed(hidden) @ p["w_down"]


# ------------------------------------------------------------------ MoE
def init_moe(gen, cfg):
    """An f32 router (d, E) and expert stacks in the ``(E, in, out)``
    layout, plus the shared experts as one dense FFN of width
    ``d_ff * num_shared_experts``."""
    m, d, f = cfg.moe, cfg.d_model, cfg.d_ff
    dt = common.dtype_of(cfg)
    E = m.num_experts
    p = {
        "router": common.dense_param(gen, (d, E), torch.float32),
        "w_gate": common.dense_param(gen, (E, d, f), dt, in_axis=1),
        "w_up": common.dense_param(gen, (E, d, f), dt, in_axis=1),
        "w_down": common.dense_param(gen, (E, f, d), dt, in_axis=1),
    }
    if m.num_shared_experts:
        p["shared"] = init_dense_ffn(gen, cfg, d_ff=f * m.num_shared_experts)
    return p


def capacity(cfg, T: int, capacity_factor: float) -> int:
    """Slots per expert for a group of T tokens: the reference's rule, in
    Python ints (it decides which tokens are dropped)."""
    m = cfg.moe
    C = max(1, int(-(-m.experts_per_token * T // m.num_experts)
                   * capacity_factor))
    C = -(-C // 8) * 8 if C > 8 else C  # MXU-align larger capacities
    return min(C, T)  # never exceed the group's token count


def _route(cfg, logits):
    """logits (G,T,E) f32 -> (weights (G,T,E) with top-k renormalized,
    probs). Only the top-k set reaches ``weights``, so the order of ties
    does not matter."""
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, cfg.moe.experts_per_token, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    weights = torch.zeros_like(probs).scatter(-1, top_idx, top_w)
    return weights, probs


def moe_ffn(cfg, p, x, *, capacity_factor: float = 1.25, use_kernels=False,
            single_group: bool = False):
    """x: (B, S, d). Groups = batch rows (or one group for single-token
    decode when ``single_group``). Returns (y, aux_loss).

    As in the reference, the dispatch one-hot (x's dtype) times the f32
    keep mask is f32, so in a bf16 model the tokens reach the experts as
    f32 (exact: each slot holds one token) and the expert FFN and the
    combine run in f32 over bf16 weights; the result is cast to x's dtype
    once, after the shared experts are added."""
    E = cfg.moe.num_experts
    B, S, d = x.shape
    orig_shape = None
    if single_group and S == 1 and B > 1:
        orig_shape = (B, S, d)
        x = x.reshape(1, B, d)
        B, S = 1, B
    C = capacity(cfg, S, capacity_factor)

    router = sharding.router_like(p["router"], x, p["w_gate"])
    logits = sharding.pinned(torch.einsum(
        "gtd,de->gte", sharding.features_over_fsdp(x.float()), router))
    weights, probs = _route(cfg, logits)  # (G,T,E)
    mask = (weights > 0).float()
    # position of each token within its expert's capacity buffer
    pos = torch.cumsum(mask, dim=1) * mask - mask  # (G,T,E), 0-based
    keep = (pos < C).float() * mask
    # one_hot(pos, C) by comparison: a slot >= C gives a zero row, as
    # jax.nn.one_hot does (F.one_hot raises)
    slots = torch.arange(C, dtype=pos.dtype, device=x.device)
    dispatch = (pos[..., None] == slots).to(x.dtype) * keep[..., None]
    dispatch = sharding.experts_like(dispatch, p["w_gate"])
    combine = dispatch.float() * weights[..., None]

    xe = ref.einsum("gtec,gtd->gecd", dispatch, x)  # (G,E,C,d)
    if use_kernels:
        ye = moe_gmm.expert_ffn(xe, p["w_gate"], p["w_up"], p["w_down"],
                                cfg.act)
    else:
        ye = ref.expert_ffn_ref(xe, p["w_gate"], p["w_up"], p["w_down"],
                                cfg.act)
    shared = (dense_ffn(cfg, p["shared"], x) if cfg.moe.num_shared_experts
              else None)

    # Switch-style load-balance aux loss
    frac_tokens = mask.mean(dim=1)          # (G,E) fraction routed
    frac_probs = probs.mean(dim=1)          # (G,E) mean router prob
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))

    # the combine last: nothing after it saves a tensor for the backward,
    # so a checkpointed block's recompute stops before it (early stop), as
    # XLA's remat leaves out a product whose output no gradient reads
    y = sharding.combine_on_shards(
        lambda c, e: ref.einsum("gtec,gecd->gtd", c, e),
        combine.to(x.dtype), ye)
    if shared is not None:
        y = y + shared
    out = y.to(x.dtype)
    if orig_shape is not None:
        out = out.reshape(orig_shape)
    return out, aux
