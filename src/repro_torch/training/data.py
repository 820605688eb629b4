"""Synthetic token data pipeline (deterministic, seekable, host-side).

A copy of the JAX package's ``training/data.py`` (numpy only).

A real deployment would swap in an SSTable/ArrayRecord reader; the
interface — ``iterate(batch_size, seq_len)`` yielding dicts of numpy
arrays — is what the train loop consumes, so the swap is local.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    """Zipf-distributed token stream with local n-gram structure so the
    loss actually decreases (pure uniform noise has no learnable signal)."""
    vocab_size: int
    seed: int = 0
    ngram_repeat: int = 8

    def batch(self, step: int, batch_size: int, seq_len: int):
        rng = np.random.default_rng(self.seed + step)
        # zipf-ish marginal over a restricted alphabet
        alpha = 1.2
        ranks = np.arange(1, min(self.vocab_size, 4096) + 1)
        probs = ranks ** (-alpha)
        probs /= probs.sum()
        base = rng.choice(len(probs), size=(batch_size, seq_len), p=probs)
        # inject learnable structure: periodic repeats of a per-row motif
        motif_len = self.ngram_repeat
        motif = base[:, :motif_len]
        reps = seq_len // (2 * motif_len)
        for r in range(reps):
            s = 2 * r * motif_len + motif_len
            base[:, s:s + motif_len] = motif
        return {"tokens": base.astype(np.int32)}

    def iterate(self, batch_size: int, seq_len: int, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch(step, batch_size, seq_len)
            step += 1


def synthetic_batch_for(cfg, shape, step: int = 0, seed: int = 0):
    """Build a host-side numpy batch matching input_specs for (cfg, shape)."""
    data = SyntheticLMData(cfg.vocab_size, seed=seed)
    v = cfg.num_visual_tokens or 0
    seq = shape.seq_len - v if shape.kind == "train" else shape.seq_len
    out = data.batch(step, shape.global_batch, max(seq, 2))
    rng = np.random.default_rng(seed + 1)
    if cfg.is_encoder_decoder:
        out["frame_embeds"] = rng.standard_normal(
            (shape.global_batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if v:
        out["visual_embeds"] = rng.standard_normal(
            (shape.global_batch, v, cfg.d_model)).astype(np.float32)
    return out
