"""Public wrappers over the port's CUDA kernels, the names of the JAX
package's ``kernels/ops.py``.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel;
on a CPU tensor it runs its plain PyTorch version (``ref.py``).
"""
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gmm import expert_ffn, gmm
from repro_torch.kernels.ssd_scan import ssd_chunk_scan

__all__ = ["decode_attention", "flash_attention", "expert_ffn", "gmm",
           "ssd_chunk_scan"]
