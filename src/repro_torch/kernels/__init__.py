"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``flash_attention.flash_attention``, ``decode_attention.decode_attention``,
``ssd_scan.ssd_chunk_scan`` and ``moe_gmm.gmm`` launch the kernels of
``csrc/`` on CUDA tensors and run ``ref.py`` on CPU tensors. Importing
builds nothing: ``build.build()`` compiles at first use.

The kernels have no backward, as the reference's Pallas kernels define no
VJP: every wrapper refuses, on either device, an input that would need a
gradient (``refuse_autograd``). Training takes the plain path
(``CallOpts(use_kernels=False)``).
"""
import torch


def refuse_autograd(name, *tensors):
    """Raise where autograd would have to differentiate through a kernel:
    grad mode on and an input that requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward (nor has the reference's "
            f"Pallas kernel); call it under torch.no_grad(), or train with "
            f"CallOpts(use_kernels=False)")
