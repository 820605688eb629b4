"""llava-next-34b — VLM with anyres tiling, stubbed vision tower
[hf:llava-hf/llava-v1.6 family].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. The ViT/SigLIP
vision encoder + projector is a STUB per the assignment: ``input_specs()``
provides precomputed anyres patch embeddings (2880 visual tokens, i.e.
a 2x2 tile grid + base image at 576 patches each) consumed by the
language decoder.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (anyres); 34b backbone per assignment",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    norm="rmsnorm",
    act="silu",
    rope_theta=5_000_000.0,
    num_visual_tokens=2880,  # anyres: 5 tiles x 576 patches
    long_context_window=8192,
)
