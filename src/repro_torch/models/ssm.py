"""Mamba2 (SSD — state-space duality) block, chunked-scan formulation.

PyTorch counterpart of the JAX package's ``models/ssm.py`` (Dao & Gu,
"Transformers are SSMs", arXiv:2405.21060). The sequence is split into
chunks; within a chunk the SSD runs in its quadratic dual form, and the
(heads, head_dim, state) SSM state carries across chunks. With
``use_kernels=True`` the scan goes to ``kernels.ssd_scan`` (the CUDA
kernel on the card), which reads B and C by group; otherwise the plain
scan ``kernels.ref.ssd_chunk_scan_ref`` runs, on B and C repeated to the
heads as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref, ssd_scan
from repro_torch.models import common, sharding


def ssm_dims(cfg):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_ch = di + 2 * s.n_groups * s.d_state
    return di, nh, conv_ch


def init_ssm(gen, cfg):
    """Random weights on ``gen``'s device, in the reference's
    distributions; ``A_log``, ``dt_bias``, ``D`` and ``norm_scale`` f32."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh, conv_ch = ssm_dims(cfg)
    dt = common.dtype_of(cfg)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    proj_out = 2 * di + 2 * s.n_groups * s.d_state + nh  # z, x, B, C, dt
    in_proj = common.dense_param(gen, (d, proj_out), dt)
    conv_w = (torch.randn((s.conv_width, conv_ch), generator=gen, **f32)
              * (1.0 / np.sqrt(s.conv_width))).to(dt)
    # dt bias: inverse-softplus of dt ~ U[1e-3, 1e-1] in log space
    u = torch.empty((nh,), **f32).uniform_(np.log(1e-3), np.log(1e-1),
                                           generator=gen)
    dt0 = torch.exp(u)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    a = torch.empty((nh,), **f32).uniform_(1.0, 16.0, generator=gen)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "A_log": torch.log(a),
        "dt_bias": dt_bias,
        "D": torch.ones((nh,), **f32),
        "norm_scale": torch.ones((di,), **f32),
        "out_proj": common.dense_param(gen, (di, d), dt),
    }


def _split_proj(cfg, proj):
    """z, x, B, C, dt of the in-projection; on a mesh z and dt keep the
    heads' sharding, x, B and C (the conv's input) come whole."""
    s = cfg.ssm
    di, nh, _ = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    return sharding.split_sharded(proj, [di, di, gn, gn, nh],
                                  [nh, None, None, None, nh])


def _split_conv(cfg, xbc):
    """x, B, C of the conv's output; on a mesh x takes the heads'
    sharding and B and C their groups' (whole where the groups do not
    divide the mesh dim)."""
    s = cfg.ssm
    di, nh, _ = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    return sharding.split_sharded(xbc, [di, gn, gn],
                                  [nh, s.n_groups, s.n_groups])


def _causal_conv(cfg, p, xbc):
    """Depthwise causal conv over (B, S, C) channels; (B, S, C) out,
    contiguous."""
    W = cfg.ssm.conv_width
    pad = sharding.pad_seq(xbc, W - 1)
    w = p["conv_w"].to(xbc.dtype).t().contiguous()[:, None, :]  # (C, 1, W)
    out = sharding.depthwise(lambda a, b: F.conv1d(a, b, groups=a.shape[1]),
                             pad.transpose(1, 2), w)
    out = out.transpose(1, 2) + p["conv_b"].to(xbc.dtype)
    return F.silu(out).contiguous()


def _gated_norm(p, y, z, eps=1e-5):
    y = y * F.silu(z.float())
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + eps)
    return y * p["norm_scale"]


def ssd_forward(cfg, p, x, *, initial_state=None, return_state=False,
                use_kernels=False):
    """Full-sequence SSD. x: (B, S, d) -> (B, S, d).

    Scans over chunks of ``cfg.ssm.chunk_size``; requires S % chunk == 0 or
    S <= chunk, as the reference does.
    """
    s = cfg.ssm
    di, nh, _ = ssm_dims(cfg)
    B_, S, _ = x.shape
    Q = min(s.chunk_size, S)
    assert S % Q == 0, f"seq {S} not divisible by chunk {Q}"
    nc = S // Q

    proj = x @ p["in_proj"]
    z, xs, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    xbc_raw = torch.cat([xs, Bm, Cm], dim=-1)
    # pre-conv window for decode (pad in case S < conv_width - 1); a copy,
    # so the cache does not hold the whole (B, S, C) input alive
    W = s.conv_width
    conv_tail = sharding.pad_seq(xbc_raw, max(W - 1 - S, 0))
    conv_tail = conv_tail[:, -(W - 1):].clone()
    xbc = _causal_conv(cfg, p, xbc_raw)
    xs, Bm, Cm = _split_conv(cfg, xbc)

    xh = xs.reshape(B_, S, nh, s.head_dim)
    Bg = Bm.reshape(B_, S, s.n_groups, s.d_state)
    Cg = Cm.reshape(B_, S, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B,S,nh)
    A = -torch.exp(p["A_log"])  # (nh,)
    dA = dt * A  # (B,S,nh), negative

    # chunked views: (nc, B, Q, ...); B and C stay grouped
    def chunked(t):
        return t.reshape(B_, nc, Q, *t.shape[2:]).transpose(0, 1)

    h0 = (initial_state if initial_state is not None
          else torch.zeros((B_, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=x.device))
    scan = ssd_scan.ssd_chunk_scan if use_kernels else ref.ssd_chunk_scan_ref
    final, yc = sharding.ssd_on_shards(scan, chunked(xh), chunked(Bg),
                                       chunked(Cg), chunked(dt), chunked(dA),
                                       h0)
    y = yc.transpose(0, 1).reshape(B_, S, nh, s.head_dim)

    y = y + p["D"][None, None, :, None] * xh.float()
    y = _gated_norm(p, y.reshape(B_, S, di), z)
    out = y.to(x.dtype) @ p["out_proj"]
    if return_state:
        return out, (conv_tail, final)
    return out


def _state_step(state, xh, dt, Bh, Ch, a, D):
    """The SSD's decode recurrence, per batch row and head: state (B, nh,
    hd, N), xh (B, nh, hd), Bh/Ch (B, nh, N), dt/a/D (B, nh) -> (the new
    state, y (B, nh, hd))."""
    dstate = torch.einsum("bhp,bhn->bhpn", xh * dt[..., None], Bh)
    new_state = a[:, :, None, None] * state + dstate
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return new_state, y + D[..., None] * xh


def ssd_decode_step(cfg, p, x, conv_state, ssm_state):
    """One-token decode. x: (B,1,d); conv_state: (B, W-1, conv_ch);
    ssm_state: (B, nh, hd, N) f32. Returns (y, new_conv_state, new_ssm_state).
    """
    s = cfg.ssm
    di, nh, _ = ssm_dims(cfg)
    B_ = x.shape[0]
    proj = x @ p["in_proj"]
    z, xs, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)  # (B,1,C)
    window = torch.cat([conv_state, xbc], dim=1)  # (B,W,C)
    new_conv_state = window[:, 1:]
    conv_out = (torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float())
                + p["conv_b"].float())
    conv_out = F.silu(conv_out)[:, None, :].to(x.dtype)
    xs, Bm, Cm = _split_conv(cfg, conv_out)

    xh = xs.reshape(B_, nh, s.head_dim).float()
    hpg = nh // s.n_groups
    Bh = Bm.reshape(B_, s.n_groups, s.d_state).repeat_interleave(hpg, dim=1)
    Ch = Cm.reshape(B_, s.n_groups, s.d_state).repeat_interleave(hpg, dim=1)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (B,nh)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)  # (B,nh)
    new_state, y = sharding.heads_on_shards(
        _state_step, ssm_state, xh, dt, Bh.float(), Ch.float(), a,
        p["D"].expand(B_, nh))
    y = _gated_norm(p, y.reshape(B_, 1, di), z)
    return y.to(x.dtype) @ p["out_proj"], new_conv_state, new_state
