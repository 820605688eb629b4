"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``flash_attention.flash_attention``, ``decode_attention.decode_attention``,
``ssd_scan.ssd_chunk_scan`` and ``moe_gmm.gmm`` launch the kernels of
``csrc/`` on CUDA tensors and run ``ref.py`` on CPU tensors. Importing
builds nothing: ``build.build()`` compiles at first use.
"""
