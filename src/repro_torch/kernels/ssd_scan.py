"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper.

The kernel (``csrc/ssd_scan.cu``) replaces the JAX package's Pallas
``ssd_chunk_scan``. On a CUDA tensor the wrapper launches it (or raises);
on a CPU tensor it runs the plain version ``ref.ssd_chunk_scan_ref``.
B and C may come with a heads axis of ``nh`` (the reference's repeated
layout) or of the ``G`` groups: the kernel reads head ``h``'s group
``h // (nh // G)`` in place, so the caller need not repeat them. Every
input may be a strided view (the chunked views of the conv output) as
long as each row's heads and their elements are contiguous.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref, refuse_autograd

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (head_dim, state size) pairs the kernel is built for: mamba2-2.7b's,
# jamba-v0.1-52b's, and their reduced test configs'
SHAPES = ((64, 128), (32, 64), (64, 16), (32, 16))

launches = 0  # kernel launches since the last reset (plain runs excluded)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use."""
    fn = build.load("ssd_scan").ssd_chunk_scan_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return fn


def ssd_chunk_scan(xc, Bc, Cc, dtc, dAc, h0):
    """xc: (nc,B,Q,nh,hd); Bc/Cc: (nc,B,Q,nh or G,N); dtc/dAc: (nc,B,Q,nh)
    f32; h0: (B,nh,hd,N) f32. Returns (final (B,nh,hd,N) f32,
    y (nc,B,Q,nh,hd) f32)."""
    global launches
    refuse_autograd("ssd_chunk_scan", xc, Bc, Cc, dtc, dAc, h0)
    if xc.device.type == "cpu":
        return ref.ssd_chunk_scan_ref(xc, Bc, Cc, dtc, dAc, h0)
    nc, B, Q, nh, hd = xc.shape
    G, N = Bc.shape[3], Bc.shape[4]
    if xc.device.type != "cuda" or any(t.device != xc.device
                                       for t in (Bc, Cc, dtc, dAc, h0)):
        raise ValueError("ssd_chunk_scan: all inputs must share one CUDA "
                         "device")
    if (xc.dtype not in DTYPES or Bc.dtype != xc.dtype or Cc.dtype != xc.dtype
            or any(t.dtype != torch.float32 for t in (dtc, dAc, h0))):
        raise TypeError(f"ssd_chunk_scan: x/B/C must be float32 or bfloat16 "
                        f"alike and dt/dA/h0 float32, got {xc.dtype}/"
                        f"{Bc.dtype}/{Cc.dtype}, {dtc.dtype}/{dAc.dtype}/"
                        f"{h0.dtype}")
    if (tuple(Bc.shape) != (nc, B, Q, G, N) or Cc.shape != Bc.shape
            or tuple(dtc.shape) != (nc, B, Q, nh) or dAc.shape != dtc.shape
            or tuple(h0.shape) != (B, nh, hd, N) or nh % G):
        raise ValueError(f"ssd_chunk_scan: shapes x {tuple(xc.shape)}, B "
                         f"{tuple(Bc.shape)}, C {tuple(Cc.shape)}, dt "
                         f"{tuple(dtc.shape)}, dA {tuple(dAc.shape)}, h0 "
                         f"{tuple(h0.shape)} do not match")
    if (hd, N) not in SHAPES:
        raise ValueError(f"ssd_chunk_scan: (head_dim, state size) "
                         f"{(hd, N)} is not one of {SHAPES}")
    if (xc.stride()[3:] != (hd, 1) or Bc.stride()[3:] != (N, 1)
            or Cc.stride()[3:] != (N, 1) or dtc.stride(3) != 1
            or dAc.stride(3) != 1):
        raise ValueError("ssd_chunk_scan: each row's heads and their "
                         "elements must be contiguous")
    if xc.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
            for t in (xc, Bc, Cc)):
        raise ValueError("ssd_chunk_scan: bf16 x, B, C must be 16-byte "
                         "aligned with row strides of a multiple of 8")
    h0 = h0.contiguous()
    # y is written (B, nc, Q, nh, hd)-contiguous, so the caller's transpose
    # back to (B, S, nh, hd) is a view
    y = torch.empty((B, nc, Q, nh, hd), dtype=torch.float32,
                    device=xc.device).transpose(0, 1)
    hout = torch.empty((B, nh, hd, N), dtype=torch.float32, device=xc.device)
    strides = (ctypes.c_longlong * 18)(*(s for t in (xc, Bc, Cc, dtc, dAc, y)
                                         for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    rc = _kernel()(DTYPES[xc.dtype], xc.data_ptr(), Bc.data_ptr(),
                   Cc.data_ptr(), dtc.data_ptr(), dAc.data_ptr(),
                   h0.data_ptr(), y.data_ptr(), hout.data_ptr(),
                   ctypes.addressof(strides), B, nc, Q, nh, G, hd, N, stream)
    if rc:
        raise RuntimeError(f"ssd_chunk_scan: kernel launch failed with CUDA "
                           f"error {rc}")
    launches += 1
    return hout, y
