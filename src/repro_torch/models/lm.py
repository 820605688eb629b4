"""Decoder-only LM (the dense, MoE, SSM, hybrid and VLM families).

PyTorch counterparts of the JAX package's ``models/lm.py``. Params are a
dict: ``embed`` (V, d), ``layers`` (one dict per layer), ``ln_f`` and,
where the config asks, ``unembed`` (d, V), ``pos`` and, for a VLM,
``visual_scale`` (a 0-d f32 one, the stand-in of the projector that the
stubbed vision tower would feed). A VLM's ``visual_embeds`` (B, V, d) are
scaled in f32, cast to the model's dtype and put before the text, so its
positions run over V + S_text; decode is the text LM's.

The unembedding returns f32 logits, as the reference's bf16 x bf16 ->
f32 einsum does. On the card it is one ``torch.mm(..., out_dtype=float32)``
over the bf16 table (cuBLAS accumulates in f32 and writes f32), so no f32
copy of the table is made. On the CPU both operands are widened to f32
first. The products of two bf16 numbers are exact in f32 either way; the
two paths differ only in the order of the f32 sums. ``aten::mm.dtype``
has no derivative, so the card's product is a ``torch.autograd.Function``
(``_Logits``) whose backward forms ``dh = g @ wᵀ`` and ``dw = hᵀ @ g``
from the f32 cotangent in f32 and casts each to its operand's dtype: the
gradients autograd gives the CPU's widened product.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks, common, sharding
from repro_torch.models.blocks import CallOpts


def init_params(cfg, *, seed: int = 0, device="cuda"):
    """Random weights from ``seed``, in the reference's distributions,
    made on ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = common.dtype_of(cfg)
    p = {
        "embed": common.embed_param(gen, (cfg.vocab_size, cfg.d_model), dt),
        "layers": blocks.init_layers(gen, cfg),
        "ln_f": common.init_norm(cfg, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = common.dense_param(gen, (cfg.d_model, cfg.vocab_size), dt)
    if cfg.pos_emb == "learned":
        p["pos"] = common.embed_param(gen, (cfg.max_learned_pos, cfg.d_model), dt)
    if cfg.num_visual_tokens:
        p["visual_scale"] = torch.ones((), dtype=torch.float32, device=dev)
    return p


def _embed(cfg, p, tokens, positions, visual_embeds=None):
    h = sharding.embed(p["embed"], tokens.long())
    if cfg.name.startswith("gemma"):
        h = (h.float() * float(cfg.d_model) ** 0.5).to(h.dtype)
    if visual_embeds is not None:
        ve = visual_embeds.float() * p["visual_scale"]
        h = torch.cat([ve.to(h.dtype), h], dim=1)
    if cfg.pos_emb == "learned":
        # XLA clamps an out-of-range gather index, so the reference's
        # positions past the table reuse its last row; clamp to match
        h = h + p["pos"][positions.long().clamp(max=cfg.max_learned_pos - 1)]
    return h


def _unembed(cfg, p, h, opts):
    w = p["embed"].t() if cfg.tie_embeddings else p["unembed"]
    return logits_of(h, sharding.shard_vocab(w, opts.logits_spec))


class _Logits(torch.autograd.Function):
    """``torch.mm(h, w, out_dtype=float32)`` with a backward in f32."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = torch.mm(g, w.float().t()).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(h.float().t(), g).to(w.dtype)
        return dh, dw


def logits_of(h, w):
    """f32 logits (B, S, V) of h (B, S, d) against w (d, V)."""
    B, S, d = h.shape
    if h.device.type == "cuda" and h.dtype != torch.float32:
        out = _Logits.apply(h.reshape(B * S, d), w)
    else:
        out = h.reshape(B * S, d).float() @ w.float()
    return out.reshape(B, S, -1)


def _positions(tokens, visual_embeds):
    """Positions 0 .. V + S_text - 1 of the visual prefix and the text."""
    S = tokens.shape[1] + (0 if visual_embeds is None
                           else visual_embeds.shape[1])
    return torch.arange(S, dtype=torch.int32, device=tokens.device)


def forward(params, cfg, tokens, *, visual_embeds=None,
            opts: CallOpts = CallOpts()):
    """Full-sequence logits. tokens: (B, S_text); visual_embeds: (B, V, d)."""
    params = sharding.gather_fsdp(params, skip=("layers",), like=tokens)
    positions = _positions(tokens, visual_embeds)
    h = _embed(cfg, params, tokens, positions, visual_embeds)
    h, aux, _ = blocks.apply_stack(cfg, params["layers"], h, positions, opts)
    h = common.apply_norm(cfg, params["ln_f"], h)
    return _unembed(cfg, params, h, opts), aux


def prefill(params, cfg, tokens, kv_len: int, *, visual_embeds=None,
            opts: CallOpts = CallOpts()):
    """Prefill: returns (last-token logits (B,1,V), cache)."""
    params = sharding.gather_fsdp(params, skip=("layers",), like=tokens)
    positions = _positions(tokens, visual_embeds)
    h = _embed(cfg, params, tokens, positions, visual_embeds)
    h, _, cache = blocks.apply_stack(cfg, params["layers"], h, positions,
                                     opts, kv_len=kv_len)
    h = common.apply_norm(cfg, params["ln_f"], h[:, -1:])
    return _unembed(cfg, params, h, opts), cache


def decode_step(params, cfg, tokens, pos, cache, *,
                opts: CallOpts = CallOpts()):
    """One decode step. tokens: (B, 1); pos: the absolute position, a 0-d
    int32 tensor or a Python int (taken as one here, on the tokens'
    device).

    Returns (logits (B,1,V), cache); the cache is updated in place.
    """
    pos = common.position(pos, tokens)
    params = sharding.gather_fsdp(params, skip=("layers",), like=tokens)
    h = sharding.embed(params["embed"], tokens.long())
    if cfg.name.startswith("gemma"):
        h = (h.float() * float(cfg.d_model) ** 0.5).to(h.dtype)
    if cfg.pos_emb == "learned":
        h = h + params["pos"].index_select(
            0, pos.clamp(max=cfg.max_learned_pos - 1).view(1))
    h, new_cache = blocks.decode_stack(cfg, params["layers"], h, pos, cache,
                                       opts)
    h = common.apply_norm(cfg, params["ln_f"], h)
    return _unembed(cfg, params, h, opts), new_cache


def init_cache(cfg, batch, kv_len, dtype=torch.bfloat16, device="cuda"):
    return blocks.init_stack_cache(cfg, batch, kv_len, dtype,
                                   resolve_device(device))
