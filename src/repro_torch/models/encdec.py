"""Whisper-style encoder-decoder transformer.

PyTorch counterpart of the JAX package's ``models/encdec.py``. The
mel-spectrogram + conv frontend is a stub: ``frame_embeds`` (B,
encoder_seq, d_model) arrive precomputed. Params are a dict: ``embed``
(V, d), the learned position tables ``pos_dec`` and ``pos_enc``,
``encoder`` and ``decoder`` (one dict per layer, as ``lm``'s ``layers``),
``ln_enc`` and ``ln_dec``. The logits come from the tied ``embed``, in
f32.

With ``use_kernels`` the encoder's non-causal self-attention and the
decoder's causal one go through the flash kernel, and decode's
self-attention through the decode kernel; cross-attention is plain
PyTorch, as the reference's is (``attention.cross_attention``). The cache
keeps the reference's layout: ``{"self": {"k", "v"}, "cross": (k, v)}``,
each tensor stacked over the decoder layers (L, B, T, K, hd); decode
writes the self-attention ring in place. With ``CallOpts.remat`` the
teacher-forced ``forward`` checkpoints each encoder and decoder layer, as
the reference's ``jax.checkpoint`` on its scanned bodies.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention, common, ffn as ffn_mod, lm, sharding
from repro_torch.models.blocks import CallOpts, _kv_into_ring


def _init_layer(gen, cfg, cross: bool):
    d = cfg.d_model
    p = {
        "ln1": common.init_norm(cfg, d, gen.device),
        "attn": attention.init_attention(gen, cfg),
        "ln_ffn": common.init_norm(cfg, d, gen.device),
        "ffn": ffn_mod.init_dense_ffn(gen, cfg),
    }
    if cross:
        p["ln_x"] = common.init_norm(cfg, d, gen.device)
        p["xattn"] = attention.init_attention(gen, cfg)
    return p


def init_params(cfg, *, seed: int = 0, device="cuda"):
    """Random weights from ``seed``, in the reference's distributions,
    made on ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = common.dtype_of(cfg)
    d = cfg.d_model
    return {
        "embed": common.embed_param(gen, (cfg.vocab_size, d), dt),
        "pos_dec": common.embed_param(gen, (cfg.max_learned_pos, d), dt),
        "pos_enc": common.embed_param(gen, (cfg.encoder_seq, d), dt),
        "encoder": [_init_layer(gen, cfg, False)
                    for _ in range(cfg.encoder_layers)],
        "decoder": [_init_layer(gen, cfg, True) for _ in range(cfg.num_layers)],
        "ln_enc": common.init_norm(cfg, d, dev),
        "ln_dec": common.init_norm(cfg, d, dev),
    }


def _rows(table, positions):
    """Rows of a learned position table; positions past its end reuse its
    last row (XLA clamps the reference's gather)."""
    return table[positions.long().clamp(max=table.shape[0] - 1)]


def encode(params, cfg, frame_embeds, opts: CallOpts = CallOpts()):
    """frame_embeds: (B, T_enc, d) stubbed conv features -> (B, T_enc, d)."""
    params = sharding.gather_fsdp(params, skip=("encoder", "decoder"))
    T = frame_embeds.shape[1]
    pos = torch.arange(T, dtype=torch.int32, device=frame_embeds.device)
    dt = common.dtype_of(cfg)
    h = frame_embeds.to(dt) + _rows(params["pos_enc"], pos).to(dt)
    for lp in params["encoder"]:
        if opts.remat:
            h = checkpoint(_encoder_layer, cfg, lp, h, pos, opts,
                           use_reentrant=False)
        else:
            h = _encoder_layer(cfg, lp, h, pos, opts)
    return common.apply_norm(cfg, params["ln_enc"], h)


def _encoder_layer(cfg, lp, h, pos, opts):
    lp = sharding.gather_fsdp(lp)
    hn = common.apply_norm(cfg, lp["ln1"], h)
    h = h + attention.self_attention(cfg, lp["attn"], hn, pos, causal=False,
                                     attn_chunk=opts.attn_chunk,
                                     use_kernels=opts.use_kernels)
    hn = common.apply_norm(cfg, lp["ln_ffn"], h)
    return h + ffn_mod.dense_ffn(cfg, lp["ffn"], hn)


def _stacked_kv(cfg, batch, T, dtype, device):
    """Zero K and V, each (L, batch, T, K, hd): one slab a decoder layer."""
    a = attention.dims_of(cfg)
    shape = (cfg.num_layers, batch, T, a.num_kv_heads, a.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def encode_cross_kv(params, cfg, enc_out):
    """Each decoder layer's cross K/V: (k, v), each (L, B, T_enc, K, hd),
    a view of an (L, B, K, T_enc, hd) tensor (the stack's one copy writes
    it so): a decode step's cross-attention then reads a head's keys and
    values in place (``attention._scores``), not a widened or transposed
    copy of the whole cache a layer and step. A sharded ``enc_out``
    (DTensor) keeps the plain stack."""
    kv = [attention.encode_kv(cfg, sharding.gather_fsdp(lp["xattn"]), enc_out)
          for lp in params["decoder"]]
    if not sharding.is_dtensor(enc_out):
        return tuple(torch.stack([t[i].transpose(1, 2) for t in kv])
                     .transpose(2, 3) for i in (0, 1))
    return (torch.stack([k for k, _ in kv]),
            torch.stack([v for _, v in kv]))


def _decoder_layer_full(cfg, lp, h, pos, cross_kv, opts, kv_len):
    """One decoder layer over the whole sequence. Returns (h, (k, v)) of
    its self-attention, in a ring of ``kv_len`` slots, or (h, None)."""
    lp = sharding.gather_fsdp(lp)
    hn = common.apply_norm(cfg, lp["ln1"], h)
    o = attention.self_attention(cfg, lp["attn"], hn, pos,
                                 attn_chunk=opts.attn_chunk,
                                 use_kernels=opts.use_kernels,
                                 return_kv=kv_len is not None)
    ce = None
    if kv_len is not None:
        o, (k, v) = o
        ce = (_kv_into_ring(k, kv_len), _kv_into_ring(v, kv_len))
    h = h + o
    hn = common.apply_norm(cfg, lp["ln_x"], h)
    h = h + attention.cross_attention(cfg, lp["xattn"], hn, *cross_kv)
    hn = common.apply_norm(cfg, lp["ln_ffn"], h)
    return h + ffn_mod.dense_ffn(cfg, lp["ffn"], hn), ce


def _decoder_input(params, cfg, tokens):
    S = tokens.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    h = (sharding.embed(params["embed"], tokens.long())
         + _rows(params["pos_dec"], pos).to(common.dtype_of(cfg)))
    return h, pos


def _logits(params, h, opts):
    return lm.logits_of(h, sharding.shard_vocab(params["embed"].t(),
                                                opts.logits_spec))


def forward(params, cfg, tokens, frame_embeds, opts: CallOpts = CallOpts()):
    """Teacher-forced full-sequence decoder logits: (logits, aux = 0)."""
    params = sharding.gather_fsdp(params, skip=("encoder", "decoder"))
    ck, cv = encode_cross_kv(params, cfg, encode(params, cfg, frame_embeds,
                                                 opts))
    h, pos = _decoder_input(params, cfg, tokens)
    for i, lp in enumerate(params["decoder"]):
        if opts.remat:
            h, _ = checkpoint(_decoder_layer_full, cfg, lp, h, pos,
                              (ck[i], cv[i]), opts, None, use_reentrant=False)
        else:
            h, _ = _decoder_layer_full(cfg, lp, h, pos, (ck[i], cv[i]), opts,
                                       None)
    h = common.apply_norm(cfg, params["ln_dec"], h)
    return _logits(params, h, opts), torch.zeros((), dtype=torch.float32,
                                           device=h.device)


def prefill(params, cfg, tokens, frame_embeds, kv_len: int,
            opts: CallOpts = CallOpts()):
    """Encode the audio and prefill the decoder: (last logits, cache)."""
    params = sharding.gather_fsdp(params, skip=("encoder", "decoder"))
    ck, cv = encode_cross_kv(params, cfg, encode(params, cfg, frame_embeds,
                                                 opts))
    h, pos = _decoder_input(params, cfg, tokens)
    rings = []
    for i, lp in enumerate(params["decoder"]):
        h, ring = _decoder_layer_full(cfg, lp, h, pos, (ck[i], cv[i]), opts,
                                      kv_len)
        rings.append(ring)
    sk = torch.stack([k for k, _ in rings])
    sv = torch.stack([v for _, v in rings])
    h = common.apply_norm(cfg, params["ln_dec"], h[:, -1:])
    return _logits(params, h, opts), {"self": {"k": sk, "v": sv},
                                      "cross": (ck, cv)}


def decode_step(params, cfg, tokens, pos, cache,
                opts: CallOpts = CallOpts()):
    """One decoder token. tokens: (B, 1); pos: the absolute position, a
    0-d int32 tensor or a Python int (taken as one here, on the tokens'
    device), clamped to the learned table for the position row. Returns
    (logits (B,1,V), cache); the self-attention ring is updated in
    place."""
    pos = common.position(pos, tokens)
    params = sharding.gather_fsdp(params, skip=("encoder", "decoder"))
    row = params["pos_dec"].index_select(
        0, pos.clamp(max=cfg.max_learned_pos - 1).view(1))
    h = (sharding.embed(params["embed"], tokens.long())
         + row.to(common.dtype_of(cfg)))
    sk, sv = cache["self"]["k"], cache["self"]["v"]
    ck, cv = cache["cross"]
    for i, lp in enumerate(params["decoder"]):
        lp = sharding.gather_fsdp(lp)
        hn = common.apply_norm(cfg, lp["ln1"], h)
        o, _, _ = attention.decode_self_attention(
            cfg, lp["attn"], hn, sk[i], sv[i], pos,
            use_kernels=opts.use_kernels)
        h = h + o
        hn = common.apply_norm(cfg, lp["ln_x"], h)
        h = h + attention.cross_attention(cfg, lp["xattn"], hn, ck[i], cv[i])
        hn = common.apply_norm(cfg, lp["ln_ffn"], h)
        h = h + ffn_mod.dense_ffn(cfg, lp["ffn"], hn)
    h = common.apply_norm(cfg, params["ln_dec"], h)
    return _logits(params, h, opts), cache


def init_cache(cfg, batch, kv_len, dtype=torch.bfloat16, device="cuda"):
    """Zeros in the reference's layout."""
    dev = resolve_device(device)
    sk, sv = _stacked_kv(cfg, batch, kv_len, dtype, dev)
    return {"self": {"k": sk, "v": sv},
            "cross": _stacked_kv(cfg, batch, cfg.encoder_seq, dtype, dev)}
