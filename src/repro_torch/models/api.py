"""Unified model API dispatching on architecture family.

  init_params(cfg, seed=, device=)            -> params dict
  forward(params, cfg, batch, opts)           -> (logits, aux_loss)
  prefill(params, cfg, batch, kv_len, opts)   -> (last logits, cache)
  decode_step(params, cfg, tokens, pos, cache, opts) -> (logits, cache)
  init_cache(cfg, batch, kv_len, dtype, device) -> cache list

``batch`` is a dict: {"tokens": (B,S)}. The encoder-decoder (whisper)
and VLM (llava) families are not ported yet and are refused.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.blocks import CallOpts


def _check_family(cfg):
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet; it "
            "arrives with the port of models/encdec.py")
    if cfg.num_visual_tokens:
        raise NotImplementedError(
            f"{cfg.name}: the VLM visual prefix is not ported yet")


def init_params(cfg, *, seed: int = 0, device="cuda"):
    _check_family(cfg)
    return lm.init_params(cfg, seed=seed, device=device)


def forward(params, cfg, batch, opts: CallOpts = CallOpts()):
    _check_family(cfg)
    return lm.forward(params, cfg, batch["tokens"], opts=opts)


def prefill(params, cfg, batch, kv_len: int, opts: CallOpts = CallOpts()):
    _check_family(cfg)
    return lm.prefill(params, cfg, batch["tokens"], kv_len, opts=opts)


def decode_step(params, cfg, tokens, pos, cache, opts: CallOpts = CallOpts()):
    _check_family(cfg)
    return lm.decode_step(params, cfg, tokens, pos, cache, opts=opts)


def init_cache(cfg, batch_size: int, kv_len: int, dtype=torch.bfloat16,
               device="cuda"):
    _check_family(cfg)
    return lm.init_cache(cfg, batch_size, kv_len, dtype, device)


__all__ = ["CallOpts", "init_params", "forward", "prefill", "decode_step",
           "init_cache"]
