"""MoE grouped matmul: the CUDA kernel's wrapper, and ``expert_ffn``.

The kernel (``csrc/moe_gmm.cu``) replaces the JAX package's Pallas
``gmm``. On a CUDA tensor ``gmm`` launches it (or raises); on a CPU tensor
it runs the plain version ``ref.gmm_ref``. Unlike the Pallas wrapper,
whose blocks must divide C, K and N (its default ``block_k=512`` does not
divide deepseek-moe-16b's d_ff of 1408), it takes any E, C, K and N.
The pairs of types taken are those the reference's MoE layer gives it:
x and w bf16, x f32 and w bf16 (a bf16 model: the one-hot dispatch
promotes the tokens to f32), x and w f32. The result has x's dtype.
``expert_ffn`` composes three ``gmm`` calls into the gated expert FFN,
as the reference's ``expert_ffn``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
         (torch.float32, torch.float32))

launches = 0  # kernel launches since the last reset (plain runs excluded)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use."""
    fn = build.load("moe_gmm").gmm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def gmm(x, w):
    """x: (E, C, K) @ w: (E, K, N) -> (E, C, N) in x's dtype, f32 sums."""
    global launches
    if x.device.type == "cpu":
        return ref.gmm_ref(x, w)
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"gmm: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"must be (E, C, K) and (E, K, N)")
    E, C, K = x.shape
    N = w.shape[2]
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gmm: x and w must share one CUDA device, got "
                         f"{x.device}, {w.device}")
    if (x.dtype, w.dtype) not in PAIRS:
        raise TypeError(f"gmm: dtypes x {x.dtype}, w {w.dtype}; the kernel "
                        f"takes (x, w) in {PAIRS}")
    if tuple(w.shape[:2]) != (E, K):
        raise ValueError(f"gmm: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm: x and w must be contiguous")
    o = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    if o.numel() == 0:
        return o
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(DTYPES[x.dtype], DTYPES[w.dtype], x.data_ptr(),
                   w.data_ptr(), o.data_ptr(), E, C, K, N, stream)
    if rc:
        raise RuntimeError(f"gmm: kernel launch failed with CUDA error {rc}")
    launches += 1
    return o


def expert_ffn(xe, w_gate, w_up, w_down, act="silu"):
    """xe: (G, E, C, d) -> (G, E, C, d) via per-expert gated FFN.

    ``act(gmm(x, Wg)) * gmm(x, Wu)`` in xe's dtype, then ``gmm(h, Wd)``,
    with the tokens of all G groups of an expert in one (G*C, d) block."""
    G, E, C, d = xe.shape
    x = xe.transpose(0, 1).reshape(E, G * C, d).contiguous()
    a = F.silu if act == "silu" else (
        lambda t: F.gelu(t, approximate="tanh"))
    h = a(gmm(x, w_gate)) * gmm(x, w_up)
    y = gmm(h.to(xe.dtype), w_down)
    return y.reshape(E, G, C, d).transpose(0, 1)
