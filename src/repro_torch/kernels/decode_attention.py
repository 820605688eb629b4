"""One-token GQA decode attention: the CUDA kernel's wrapper.

The kernel (``csrc/decode_attention.cu``: one launch, the splits of each
(batch, KV head) one thread-block cluster) replaces the JAX package's
Pallas ``decode_attention``. On a CUDA tensor the wrapper launches it (or
raises); on a CPU tensor it runs the plain version
``ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref, refuse_autograd

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
MAX_G = 16          # query heads per KV head
TILE = 64           # keys per tile inside the kernel (the mask's granularity)
MAX_SPLIT = 8       # blocks of a cluster: the portable cluster size
MAX_T = 131072      # cache slots (the kernel keeps the mask's bits in shared memory)
BLOCKS_PER_SM = 1   # blocks an SM the planner aims at

# wrapper calls that launched the kernel (plain runs excluded), and the
# kernels a replay of a captured decode step ran (``serving/graphs.py``)
launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use."""
    fn = build.load("decode_attention").decode_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_splits(B: int, K: int, T: int, n_sm: int = 132) -> int:
    """Blocks (one cluster) per (batch, KV head): enough for about
    ``BLOCKS_PER_SM`` blocks on each SM, at most ``MAX_SPLIT`` and at most
    one per 64-key tile. Where B*K alone fills the card, one. Two blocks an
    SM (64 clusters of 4 at B*K = 64) made more clusters than the card
    placed at once, and a tail wave."""
    tiles = -(-T // TILE)
    return max(1, min(MAX_SPLIT, tiles, BLOCKS_PER_SM * n_sm // (B * K)))


def decode_attention(q, k, v, valid):
    """q: (B,1,K,G,hd); k,v: (B,T,K,hd); valid: (T,) bool -> (B,1,K,G,hd).

    One kernel launch; no scratch. An all-false mask gives the mean of V
    (the Pallas kernel's finite NEG_INF), on the card as in the plain
    version."""
    global launches
    refuse_autograd("decode_attention", q, k, v)
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
    if (hd not in HEAD_DIMS or not 1 <= G <= MAX_G or B * K > 65535
            or not 1 <= T <= MAX_T):
        raise ValueError(f"decode_attention: head_dim {hd} (of {HEAD_DIMS}) "
                         f"with {G} query heads per KV head (1 to {MAX_G}), "
                         f"B*K {B * K} and {T} cache slots (at most {MAX_T}) "
                         f"is not supported")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v, valid)):
        raise ValueError("decode_attention: q, k, v, valid must be "
                         "contiguous and 16-byte aligned")
    o = torch.empty_like(q)
    ns = n_splits(B, K, T, _n_sm(q.device.index or 0))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   valid.data_ptr(), o.data_ptr(), B, T, K, G, hd, ns,
                   1.0 / (hd ** 0.5), stream)
    if rc:
        raise RuntimeError(f"decode_attention: kernel launch failed with "
                           f"CUDA error {rc}")
    launches += 1
    return o
