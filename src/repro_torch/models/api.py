"""Unified model API dispatching on architecture family.

  init_params(cfg, seed=, device=)            -> params dict
  forward(params, cfg, batch, opts)           -> (logits, aux_loss)
  prefill(params, cfg, batch, kv_len, opts)   -> (last logits, cache)
  decode_step(params, cfg, tokens, pos, cache, opts) -> (logits, cache)
  init_cache(cfg, batch, kv_len, dtype, device) -> cache

``batch`` is a dict: {"tokens": (B,S)} plus, per family,
{"frame_embeds": (B,T_enc,d)} (audio) or {"visual_embeds": (B,V,d)} (vlm).
A decode step's ``pos`` is a 0-d int32 tensor, as the reference's traced
scalar, or a Python int, which the family's ``decode_step`` turns into
one on the tokens' device at its entry.
"""
from __future__ import annotations

import torch

from repro_torch.models import encdec, lm
from repro_torch.models.blocks import CallOpts


def init_params(cfg, *, seed: int = 0, device="cuda"):
    if cfg.is_encoder_decoder:
        return encdec.init_params(cfg, seed=seed, device=device)
    return lm.init_params(cfg, seed=seed, device=device)


def forward(params, cfg, batch, opts: CallOpts = CallOpts()):
    if cfg.is_encoder_decoder:
        return encdec.forward(params, cfg, batch["tokens"],
                              batch["frame_embeds"], opts)
    return lm.forward(params, cfg, batch["tokens"],
                      visual_embeds=batch.get("visual_embeds"), opts=opts)


def prefill(params, cfg, batch, kv_len: int, opts: CallOpts = CallOpts()):
    if cfg.is_encoder_decoder:
        return encdec.prefill(params, cfg, batch["tokens"],
                              batch["frame_embeds"], kv_len, opts)
    return lm.prefill(params, cfg, batch["tokens"], kv_len,
                      visual_embeds=batch.get("visual_embeds"), opts=opts)


def decode_step(params, cfg, tokens, pos, cache, opts: CallOpts = CallOpts()):
    if cfg.is_encoder_decoder:
        return encdec.decode_step(params, cfg, tokens, pos, cache, opts)
    return lm.decode_step(params, cfg, tokens, pos, cache, opts=opts)


def init_cache(cfg, batch_size: int, kv_len: int, dtype=torch.bfloat16,
               device="cuda"):
    if cfg.is_encoder_decoder:
        return encdec.init_cache(cfg, batch_size, kv_len, dtype, device)
    return lm.init_cache(cfg, batch_size, kv_len, dtype, device)


__all__ = ["CallOpts", "init_params", "forward", "prefill", "decode_step",
           "init_cache"]
