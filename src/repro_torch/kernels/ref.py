"""Plain PyTorch versions of the kernels (the allclose targets).

Same layouts and arithmetic as the JAX package's ``kernels/ref.py``:
f32 scores and softmax, masked entries at -inf (decode: at the Pallas
kernel's finite -2e38), output cast back to q's dtype; the SSD scan in
f32, chunk by chunk; the grouped matmul in f32, cast back to x's dtype
(and the gated pair of two of them). The kernel wrappers run these on
CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B,S,K,G,hd); k,v: (B,T,K,hd) -> (B,S,K,G,hd). f32 softmax."""
    S, hd = q.shape[1], q.shape[-1]
    T = k.shape[1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.to(q.dtype)


def decode_attention_ref(q, k, v, valid):
    """q: (B,1,K,G,hd); k,v: (B,T,K,hd); valid: (T,) bool -> (B,1,K,G,hd).

    Invalid slots score the Pallas kernel's finite NEG_INF = -2e38, not
    -inf: the same result for any mask with a valid slot, and the mean of
    V, not NaN, for an all-false mask."""
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    s = s.masked_fill(~valid, -2.0e38)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.to(q.dtype)


def ssd_chunk_scan_ref(xc, Bc, Cc, dtc, dAc, h0):
    """SSD chunked scan oracle.

    xc: (nc, B, Q, nh, hd); Bc/Cc: (nc, B, Q, nh or G, N), a heads axis of
    G groups repeated to nh heads (head h reads group h // (nh // G));
    dtc/dAc: (nc, B, Q, nh); h0: (B, nh, hd, N) f32.
    Returns (final_state, y (nc, B, Q, nh, hd) f32).
    """
    Q, nh = xc.shape[2], xc.shape[3]
    if Bc.shape[3] != nh:
        Bc = Bc.repeat_interleave(nh // Bc.shape[3], dim=3)
        Cc = Cc.repeat_interleave(nh // Cc.shape[3], dim=3)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    h = h0.float()
    ys = []
    for x_i, B_i, C_i, dt_i, dA_i in zip(xc.float(), Bc.float(), Cc.float(),
                                         dtc.float(), dAc.float()):
        cum = torch.cumsum(dA_i, dim=1)                        # (B,Q,nh)
        total = cum[:, -1]                                     # (B,nh)
        cb = torch.einsum("bihn,bjhn->bhij", C_i, B_i)         # (B,nh,Q,Q)
        li = cum.transpose(1, 2)[:, :, :, None]
        lj = cum.transpose(1, 2)[:, :, None, :]
        # mask BEFORE exp: cum decreases, so li - lj > 0 above the diagonal
        decay = torch.exp((li - lj).masked_fill(~tril, -1e30))
        scores = cb * decay * dt_i.transpose(1, 2)[:, :, None, :]
        y_intra = torch.einsum("bhij,bjhp->bihp", scores, x_i)
        y_inter = torch.einsum("bihn,bhpn->bihp",
                               C_i * torch.exp(cum)[..., None], h)
        w = dt_i * torch.exp(total[:, None, :] - cum)          # (B,Q,nh)
        dstate = torch.einsum("bjhp,bjhn->bhpn", x_i * w[..., None], B_i)
        h = torch.exp(total)[:, :, None, None] * h + dstate
        ys.append(y_intra + y_inter)
    return h, torch.stack(ys)


def gmm_ref(x, w):
    """Grouped matmul oracle: x (E,C,K) @ w (E,K,N) -> (E,C,N), f32 acc."""
    return torch.einsum("eck,ekn->ecn", x.float(), w.float()).to(x.dtype)


def _act(name):
    if name == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def gmm_gated_ref(x, w_gate, w_up, act="silu"):
    """Gated pair oracle: ``act(gmm(x, Wg)) * gmm(x, Wu)`` in x's dtype.

    x: (E,C,K), or (G,E,C,K) whose G groups of an expert become its G*C
    rows; w_gate, w_up: (E,K,N) -> (E,C,N) or (E,G*C,N)."""
    if x.dim() == 4:
        G, E, C, K = x.shape
        x = x.transpose(0, 1).reshape(E, G * C, K)
    return _act(act)(gmm_ref(x, w_gate)) * gmm_ref(x, w_up)


def einsum(eq, a, b):
    """``torch.einsum`` of two operands in their promoted dtype, as
    ``jnp.einsum`` computes a bf16 x f32 product in f32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def expert_ffn_ref(xe, w_gate, w_up, w_down, act="silu"):
    """xe: (G,E,C,d); weights (E,d,f)/(E,f,d) -> (G,E,C,d)."""
    a = _act(act)
    h = a(einsum("gecd,edf->gecf", xe, w_gate)) \
        * einsum("gecd,edf->gecf", xe, w_up)
    return einsum("gecf,efd->gecd", h, w_down)
