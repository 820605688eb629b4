"""MoE grouped matmul: the CUDA kernels' wrappers, and ``expert_ffn``.

The kernels (``csrc/moe_gmm.cu``) replace the JAX package's Pallas
``gmm``. On a CUDA tensor ``gmm`` and ``gmm_gated`` launch them (or
raise); on a CPU tensor they run the plain versions ``ref.gmm_ref`` and
``ref.gmm_gated_ref``. Unlike the Pallas wrapper, whose blocks must divide
C, K and N (its default ``block_k=512`` does not divide deepseek-moe-16b's
d_ff of 1408), they take any E, C, K and N. The pairs of types taken are
those the reference's MoE layer gives them: x and w bf16, x f32 and w bf16
(a bf16 model: the one-hot dispatch promotes the tokens to f32), x and w
f32. The result has x's dtype. ``expert_ffn`` is the gated expert FFN of
the reference's ``expert_ffn`` in two launches: ``gmm_gated`` (gate and
up, with the activation and the product) and ``gmm`` (down). On the
prefill path a call also runs a pre-pass that writes x's bf16 planes into
scratch the wrapper allocates (``gmm_workspace_bytes`` says how much); it
is part of the one launch counted.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref, refuse_autograd

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
         (torch.float32, torch.float32))
ACTS = {"silu": 1, "gelu": 2}  # gelu: the tanh approximation

# kernel launches since the last reset (plain runs excluded; a replay of
# a captured decode step adds the ones it ran, ``serving/graphs.py``): of
# gmm, and of gmm_gated
launches = 0
gated_launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``gmm``, built and loaded at first use."""
    fn = build.load("moe_gmm").gmm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _gated_kernel():
    """The C entry point of ``gmm_gated``, built and loaded at first use."""
    fn = build.load("moe_gmm").gmm_gated_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_long] * 3
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_long,
                      ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _workspace_bytes():
    """The C function that sizes a call's scratch, loaded at first use."""
    fn = build.load("moe_gmm").gmm_workspace_bytes
    fn.restype = ctypes.c_long
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_long] * 3)
    return fn


def _scratch(nb, x, w0, w1, o, E, G, C, K, N, se, sg, sc):
    """Device scratch for one call (an empty tensor where none is needed)."""
    n = _workspace_bytes()(nb, DTYPES[x.dtype], DTYPES[w0.dtype],
                           x.data_ptr(), w0.data_ptr(), w1.data_ptr(),
                           o.data_ptr(), E, G, C, K, N, se, sg, sc)
    return torch.empty(n, dtype=torch.uint8, device=x.device)


def gmm(x, w):
    """x: (E, C, K) @ w: (E, K, N) -> (E, C, N) in x's dtype, f32 sums."""
    global launches
    refuse_autograd("gmm", x, w)
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
    ws = _scratch(1, x, w, w, o, E, 1, C, K, N, C * K, E * C * K, K)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(DTYPES[x.dtype], DTYPES[w.dtype], x.data_ptr(),
                   w.data_ptr(), o.data_ptr(), E, C, K, N, ws.data_ptr(),
                   ws.numel(), stream)
    if rc:
        raise RuntimeError(f"gmm: kernel launch failed with CUDA error {rc}")
    launches += 1
    return o


def gmm_gated(x, w_gate, w_up, act="silu"):
    """``act(gmm(x, w_gate)) * gmm(x, w_up)`` in one launch.

    x: (E, C, K), or (G, E, C, K) read in place (any strides with K
    contiguous), whose G groups of C tokens of an expert become its G*C
    rows; w_gate, w_up: (E, K, N) -> (E, C, N) or (E, G*C, N) in x's
    dtype, f32 sums. act: "silu" or "gelu" (tanh approximation)."""
    global gated_launches
    refuse_autograd("gmm_gated", x, w_gate, w_up)
    if x.device.type == "cpu":
        return ref.gmm_gated_ref(x, w_gate, w_up, act)
    if x.dim() not in (3, 4) or w_gate.dim() != 3:
        raise ValueError(f"gmm_gated: x {tuple(x.shape)} and w "
                         f"{tuple(w_gate.shape)} must be (E, C, K) or "
                         f"(G, E, C, K) and (E, K, N)")
    xs = x if x.dim() == 4 else x.unsqueeze(0)
    G, E, C, K = xs.shape
    N = w_gate.shape[2]
    if tuple(w_gate.shape[:2]) != (E, K) or w_up.shape != w_gate.shape:
        raise ValueError(f"gmm_gated: w_gate {tuple(w_gate.shape)} / w_up "
                         f"{tuple(w_up.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if ((x.dtype, w_gate.dtype) not in PAIRS or w_up.dtype != w_gate.dtype):
        raise TypeError(f"gmm_gated: dtypes x {x.dtype}, w {w_gate.dtype}/"
                        f"{w_up.dtype}; the kernel takes (x, w) in {PAIRS}")
    if act not in ACTS:
        raise ValueError(f"gmm_gated: act {act!r} not in {tuple(ACTS)}")
    if (x.device.type != "cuda" or w_gate.device != x.device
            or w_up.device != x.device):
        raise ValueError(f"gmm_gated: x and weights must share one CUDA "
                         f"device, got {x.device}, {w_gate.device}, "
                         f"{w_up.device}")
    if not (w_gate.is_contiguous() and w_up.is_contiguous()
            and (K <= 1 or xs.stride(3) == 1)):
        raise ValueError("gmm_gated: the weights must be contiguous and x's "
                         "last dimension contiguous")
    o = torch.empty((E, G * C, N), dtype=x.dtype, device=x.device)
    if o.numel() == 0:
        return o
    sg, se, sc = xs.stride(0), xs.stride(1), xs.stride(2)
    if G == 1:  # a stride of a size-1 dimension is free: a valid one
        sg = se * E
    ws = _scratch(2, x, w_gate, w_up, o, E, G, C, K, N, se, sg, sc)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _gated_kernel()(DTYPES[x.dtype], DTYPES[w_gate.dtype], x.data_ptr(),
                         w_gate.data_ptr(), w_up.data_ptr(), o.data_ptr(),
                         E, G, C, K, N, se, sg, sc, ACTS[act], ws.data_ptr(),
                         ws.numel(), stream)
    if rc:
        raise RuntimeError(f"gmm_gated: kernel launch failed with CUDA "
                           f"error {rc}")
    gated_launches += 1
    return o


def expert_ffn(xe, w_gate, w_up, w_down, act="silu"):
    """xe: (G, E, C, d) -> (G, E, C, d) via per-expert gated FFN.

    ``gmm_gated`` reads xe in place and gives h = act(x Wg) * (x Wu) in
    xe's dtype, the tokens of all G groups of an expert as the rows of one
    (G*C, f) block; then ``gmm(h, Wd)``."""
    refuse_autograd("expert_ffn", xe, w_gate, w_up, w_down)
    G, E, C, d = xe.shape
    h = gmm_gated(xe, w_gate, w_up, "silu" if act == "silu" else "gelu")
    y = gmm(h, w_down)
    return y.reshape(E, G, C, d).transpose(0, 1)
