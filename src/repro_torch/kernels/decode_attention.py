"""One-token GQA decode attention: the CUDA kernel's wrapper.

The kernels (``csrc/decode_attention.cu``: a split-T partial pass and a
combine pass) replace the JAX package's Pallas ``decode_attention``. On a
CUDA tensor the wrapper launches them (or raises); on a CPU tensor it
runs the plain version ``ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
TILE = 64           # keys per tile inside the kernel
TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs

launches = 0  # wrapper calls that launched the kernels (plain runs excluded)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use."""
    fn = build.load("decode_attention").decode_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def split_len(B: int, K: int, T: int) -> int:
    """Keys per partial block: a multiple of the tile, short enough that
    the (splits x B*K) grid gives about ``TARGET_BLOCKS`` blocks."""
    tiles = -(-T // TILE)
    want = max(1, -(-TARGET_BLOCKS // (B * K)))
    return TILE * -(-tiles // min(tiles, want))


def decode_attention(q, k, v, valid):
    """q: (B,1,K,G,hd); k,v: (B,T,K,hd); valid: (T,) bool -> (B,1,K,G,hd)."""
    global launches
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, valid)
    B, one, K, G, hd = q.shape
    T = k.shape[1]
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v, valid)):
        raise ValueError("decode_attention: q, k, v, valid must share one "
                         "CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    if valid.dtype != torch.bool or tuple(valid.shape) != (T,):
        raise ValueError(f"decode_attention: valid must be a ({T},) bool "
                         f"tensor, got {valid.dtype} {tuple(valid.shape)}")
    if one != 1 or tuple(k.shape) != (B, T, K, hd) or v.shape != k.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if hd not in HEAD_DIMS or G > 16 * (128 // hd):
        raise ValueError(f"decode_attention: head_dim {hd} (of {HEAD_DIMS}) "
                         f"with {G} query heads per KV head is not supported")
    if not (valid.is_contiguous() and all(
            t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v))):
        raise ValueError("decode_attention: inputs must be contiguous, and "
                         "q, k, v 16-byte aligned")
    o = torch.empty_like(q)
    sl = split_len(B, K, T)
    n_split = -(-T // sl)
    # per split and query head: the running max, the sum, and hd of acc
    rows = B * K * n_split * G
    part = torch.empty((rows * (2 + hd),), dtype=torch.float32,
                       device=q.device)
    m_ptr = part.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   valid.data_ptr(), o.data_ptr(), m_ptr, m_ptr + 4 * rows,
                   m_ptr + 8 * rows, B, T, K, G, hd, sl, 1.0 / (hd ** 0.5),
                   stream)
    if rc:
        raise RuntimeError(f"decode_attention: kernel launch failed with "
                           f"CUDA error {rc}")
    launches += 1
    return o
