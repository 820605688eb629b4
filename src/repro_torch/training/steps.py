"""Serve step functions: the units ``PodEngine`` dispatches.

Counterparts of the JAX package's ``make_prefill_step`` and
``make_decode_step``: plain functions (PyTorch runs eagerly; nothing is
compiled). The train step arrives with the port of ``training/``.
"""
from __future__ import annotations

from repro_torch import models
from repro_torch.models import CallOpts


def make_prefill_step(cfg, kv_len: int, opts: CallOpts = CallOpts()):
    def prefill_step(params, batch):
        logits, cache = models.prefill(params, cfg, batch, kv_len, opts)
        return logits, cache
    return prefill_step


def make_decode_step(cfg, opts: CallOpts = CallOpts()):
    def decode_step(params, tokens, pos, cache):
        return models.decode_step(params, cfg, tokens, pos, cache, opts=opts)
    return decode_step
