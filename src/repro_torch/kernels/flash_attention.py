"""Prefill GQA flash attention: the CUDA kernel's wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's
Pallas ``flash_attention``. On a CUDA tensor the wrapper launches it (or
raises); on a CPU tensor it runs the plain version ``ref.flash_attention_ref``.
Unlike the Pallas wrapper it takes any S and T (the kernel masks the
ragged edge), since ``Batcher.pad_prompts`` gives prompts of any length.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref, refuse_autograd

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)

launches = 0  # kernel launches since the last reset (plain runs excluded)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use."""
    fn = build.load("flash_attention").flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, S, K, G, hd); k, v: (B, T, K, hd) -> (B, S, K, G, hd)."""
    global launches
    refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v must share one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    if tuple(k.shape) != (B, T, K, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be contiguous and "
                         "16-byte aligned")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, S, T, K, G, hd, int(bool(causal)), int(window),
            1.0 / (hd ** 0.5), stream)
    if rc:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc}")
    launches += 1
    return o
