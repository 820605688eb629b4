"""whisper-medium — encoder-decoder with stubbed conv/mel frontend
[arXiv:2212.04356].

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865. The mel-spectrogram +
conv feature extractor is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings (1500 x d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356 (Whisper), whisper-medium card",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    norm="layernorm",
    act="gelu_plain",
    qkv_bias=True,
    pos_emb="learned",
    is_encoder_decoder=True,
    encoder_layers=24,
    encoder_seq=1500,
    # long_500k skipped: a 500k-token decoder transcript has no audio
    # analogue (30s audio = 1500 frames).
)
