"""Config registry of the port: every architecture of the JAX package's
``configs/`` (the dense, MoE, SSM, hybrid, VLM and encoder-decoder
families), the four input shapes, and the GPU-type catalogue (copies of
the JAX package's modules)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, ShapeConfig, reduced
from repro_torch.configs.gpus import (DEFAULT_GPU_TYPE, GPU_TYPES, GPUType,
                                      fleet_from_names, get_gpu_type)
from repro_torch.configs.shapes import SHAPES, get_shape

from repro_torch.configs import (command_r_35b, dbrx_132b, deepseek_moe_16b,
                                 gemma_7b, jamba_v0p1_52b, llava_next_34b,
                                 mamba2_2p7b, olmo_1b, qwen2p5_3b,
                                 whisper_medium)

# the JAX package's registry order (RaPP's build_corpus draws in it)
ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (mamba2_2p7b, dbrx_132b, whisper_medium, qwen2p5_3b,
                   jamba_v0p1_52b, llava_next_34b, deepseek_moe_16b,
                   gemma_7b, command_r_35b, olmo_1b)}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


def combo_is_supported(arch: str, shape: str) -> bool:
    """Whether (arch x shape) is a supported dry-run combination.

    The only principled skip: whisper-medium x long_500k (a 500k-token
    decoder transcript has no audio analogue)."""
    if shape == "long_500k" and arch == "whisper-medium":
        return False
    return True


__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "reduced",
    "SHAPES", "get_shape", "ARCHS", "get_config", "list_archs",
    "combo_is_supported",
    "GPUType", "GPU_TYPES", "DEFAULT_GPU_TYPE", "get_gpu_type",
    "fleet_from_names",
]
