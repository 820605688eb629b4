"""Config registry of the port: the architectures its slices serve, the
input-shape dataclass, and the GPU-type catalogue (copies of the JAX
package's ``configs/``). Further architectures arrive with the slices
that bring their layers (the encoder-decoder and VLM families)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, ShapeConfig, reduced
from repro_torch.configs.gpus import (DEFAULT_GPU_TYPE, GPU_TYPES, GPUType,
                                      fleet_from_names, get_gpu_type)

from repro_torch.configs import (dbrx_132b, deepseek_moe_16b, jamba_v0p1_52b,
                                 mamba2_2p7b, olmo_1b, qwen2p5_3b)

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (qwen2p5_3b, olmo_1b, mamba2_2p7b, deepseek_moe_16b,
                   dbrx_132b, jamba_v0p1_52b)}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "reduced",
    "ARCHS", "get_config", "list_archs",
    "GPUType", "GPU_TYPES", "DEFAULT_GPU_TYPE", "get_gpu_type",
    "fleet_from_names",
]
