"""AdamW with a cosine/warmup schedule, in PyTorch.

The counterpart of the JAX package's ``training/optimizer.py``, formula
for formula: the update math runs in f32 tensors (the schedule included),
the clip scale is ``min(1, clip / (gnorm + 1e-9))``, the bias corrections
come from ``step + 1``, decoupled weight decay reaches only leaves of two
or more dimensions (in the reference's layout, see ``apply_updates``),
and each new parameter is cast back to its own dtype.
Params, gradients and moments are trees (dicts, lists, tuples) of
tensors; ``apply_updates`` is functional: it returns new params and a new
state and changes nothing it was given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0
    # moment store dtype: "float32" (default) or "bfloat16"; the update
    # math still runs in f32
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the params' device
    mu: object          # tree like params (moment_dtype)
    nu: object          # tree like params (moment_dtype)


def init_opt_state(params, moment_dtype: str = "float32") -> OptState:
    dt = getattr(torch, moment_dtype)
    leaves, spec = pytree.tree_flatten(params)

    def zeros():
        return pytree.tree_unflatten(
            [torch.zeros(p.shape, dtype=dt, device=p.device) for p in leaves],
            spec)
    step = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    return OptState(step=step, mu=zeros(), nu=zeros())


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (a tensor or an int), an f32 tensor."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree):
    leaves = pytree.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: OptState,
                  decay=None):
    """Returns (new_params, new_state, metrics).

    ``decay`` (a tree like params, of bools) says which leaves take the
    decoupled weight decay; by default those of two or more dimensions,
    the reference's rule. ``make_train_step`` passes the rule read on the
    reference's layout, where a layer of the scanned periods carries one
    more dimension (``weights.jax_ndim``)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    c1 = 1.0 - cfg.b1 ** step.float()
    c2 = 1.0 - cfg.b2 ** step.float()
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v, wd):
        g = g.float() * scale
        m = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if wd:  # decoupled weight decay (on matrices only, by default)
            delta = delta + cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        return new_p.to(p.dtype), m.to(mdt), v.to(mdt)

    flat_p, spec = pytree.tree_flatten(params)
    flat_g = pytree.tree_leaves(grads)
    flat_m = pytree.tree_leaves(state.mu)
    flat_v = pytree.tree_leaves(state.nu)
    flat_d = ([p.dim() >= 2 for p in flat_p] if decay is None
              else pytree.tree_leaves(decay))
    if not (len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v)
            == len(flat_d)):
        raise ValueError(f"apply_updates: {len(flat_p)} params, "
                         f"{len(flat_g)} grads, {len(flat_m)}/{len(flat_v)} "
                         f"moments, {len(flat_d)} decay flags")
    out = [upd(*leaves) for leaves in zip(flat_p, flat_g, flat_m, flat_v,
                                          flat_d)]
    new_params = pytree.tree_unflatten([o[0] for o in out], spec)
    new_mu = pytree.tree_unflatten([o[1] for o in out], spec)
    new_nu = pytree.tree_unflatten([o[2] for o in out], spec)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, OptState(step, new_mu, new_nu), metrics
