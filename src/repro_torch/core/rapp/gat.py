"""Graph Attention (GAT, Velickovic et al. 2018) blocks in PyTorch.

The counterpart of the JAX package's ``core/rapp/gat.py``, formula for
formula, in f32. Dense-adjacency formulation (graphs are padded to
MAX_NODES): per head, e_ij = LeakyReLU(a_src . Wh_i + a_dst . Wh_j),
attention is softmaxed over the masked neighborhood, and features
aggregate as h'_i = ELU(sum_j a_ij Wh_j). The attention mechanism
captures potential kernel-fusion affinity between adjacent operators
(paper §3.2).

Every function takes any number of leading axes (a batch of graphs) on
its inputs, where the reference vmaps.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def init_gat_layer(gen: torch.Generator, in_dim: int, out_dim: int,
                   heads: int):
    scale = 1.0 / np.sqrt(in_dim)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device) * scale
    return {"W": normal(heads, in_dim, out_dim),
            "a_src": normal(heads, out_dim),
            "a_dst": normal(heads, out_dim)}


def gat_layer(p, h, adj, mask):
    """h: (..., N, F); adj: (..., N, N) 1/0; mask: (..., N) 1/0
    -> (..., N, heads*out)."""
    hw = torch.einsum("...nf,hfo->...hno", h, p["W"])        # (..., H, N, O)
    src = torch.einsum("...hno,ho->...hn", hw, p["a_src"])   # (..., H, N)
    dst = torch.einsum("...hno,ho->...hn", hw, p["a_dst"])
    e = src[..., :, :, None] + dst[..., :, None, :]          # (..., H, N, N)
    e = F.leaky_relu(e, 0.2)
    neigh = (adj * mask[..., None, :] * mask[..., :, None])[..., None, :, :]
    keep = neigh > 0
    # the reference's where(neigh > 0, e, -1e30) and where(..., att, 0)
    att = torch.softmax(e.masked_fill(~keep, -1e30), dim=-1) * keep
    out = torch.einsum("...hij,...hjo->...hio", att, hw)     # (..., H, N, O)
    out = F.elu(out)
    H, N, O = out.shape[-3:]
    out = out.transpose(-3, -2).reshape(*out.shape[:-3], N, H * O)
    return out * mask[..., :, None]


def init_mlp(gen: torch.Generator, dims):
    return [{"W": torch.randn((a, b), generator=gen, device=gen.device)
             / np.sqrt(a),
             "b": torch.zeros((b,), device=gen.device)}
            for a, b in zip(dims[:-1], dims[1:])]


def mlp(params, x, final_linear=True):
    """The hidden activation is the tanh GELU, ``jax.nn.gelu``'s default."""
    for i, layer in enumerate(params):
        x = x @ layer["W"] + layer["b"]
        if i < len(params) - 1 or not final_linear:
            x = F.gelu(x, approximate="tanh")
    return x
