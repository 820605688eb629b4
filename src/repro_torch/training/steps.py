"""Loss and train/serve step functions.

Counterparts of the JAX package's ``training/steps.py``: plain functions
(PyTorch runs eagerly; on the card ``PodEngine`` captures the decode step
as a CUDA graph). ``make_prefill_step`` and ``make_decode_step`` are the
units ``PodEngine`` dispatches;
``make_train_step`` takes one AdamW step on the plain path.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch import models
from repro_torch.models import CallOpts, sharding
from repro_torch.training import optimizer as opt_mod
from repro_torch.weights import jax_ndim


def cross_entropy(logits, labels, mask=None):
    """logits: (B,S,V) f32; labels: (B,S) int. Mean NLL over mask.

    The gold logit comes from ``sharding.gold_logits``: a gather on one
    device, the reference's one-hot sum on a mesh."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = sharding.gold_logits(logits, labels)
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg, batch, opts: CallOpts):
    logits, aux = models.forward(params, cfg, batch, opts)
    logits = sharding.constrain(logits, opts.logits_spec)
    tokens = batch["tokens"]
    # VLM: logits cover [visual | text]; next-token loss on the text span.
    v = cfg.num_visual_tokens or 0
    text_logits = logits[:, v:-1] if v else logits[:, :-1]
    labels = tokens[:, 1:]
    loss = cross_entropy(text_logits, labels)
    lb_coef = cfg.moe.load_balance_coef if cfg.moe else 0.0
    return loss + lb_coef * aux, {"ce": loss, "aux": aux}


def make_train_step(cfg, adamw: opt_mod.AdamWConfig,
                    opts: CallOpts = CallOpts(remat=True),
                    microbatches: int = 1, grad_specs=None):
    """Train step with optional gradient-accumulation microbatching.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` returns new params and state and leaves the old ones as
    they were. With ``microbatches=M`` the batch is taken as M sequential
    slices, split strided as the reference's (row ``i * M + m`` goes to
    microbatch ``m``), with the gradients summed in f32 and averaged: the
    loss and gradients are the means of the whole batch's.

    ``grad_specs`` (a spec tree like params: the reference's sharding
    constraints on each microbatch's gradients) redistributes DTensor
    gradients and leaves plain ones alone. ``opts.use_kernels`` is
    refused: the kernels have no backward, as the reference's Pallas
    kernels define no VJP, and the reference trains on the plain path.
    """
    if opts.use_kernels:
        raise ValueError("make_train_step: the kernels have no backward; "
                         "train with CallOpts(use_kernels=False)")
    if microbatches < 1:
        raise ValueError(f"make_train_step: microbatches {microbatches}")

    gspecs = (None if grad_specs is None else
              pytree.tree_leaves(grad_specs, is_leaf=lambda s: s is None))

    def grad_one(flat, spec, batch):
        work = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            loss, parts = loss_fn(pytree.tree_unflatten(work, spec), cfg,
                                  batch, opts)
            grads = torch.autograd.grad(loss, work)
        if grad_specs is not None:
            grads = [sharding.constrain(g, s) for g, s in zip(grads, gspecs)]
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                list(grads))

    def train_step(params, opt_state, batch):
        flat, spec = pytree.tree_flatten(params)
        M = microbatches
        if M == 1:
            loss, parts, grads = grad_one(flat, spec, batch)
        else:
            rows = {x.shape[0] for x in batch.values()}
            if len(rows) != 1 or rows.pop() % M:
                raise ValueError(f"train_step: batch rows "
                                 f"{[tuple(x.shape) for x in batch.values()]}"
                                 f" do not split into {M} microbatches")
            mb = {k: x.reshape((x.shape[0] // M, M) + tuple(x.shape[1:]))
                  .transpose(0, 1) for k, x in batch.items()}
            dev = flat[0].device
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            psum = {"ce": lsum.clone(), "aux": lsum.clone()}
            for m in range(M):
                loss_m, parts_m, g = grad_one(
                    flat, spec, {k: x[m] for k, x in mb.items()})
                for a, b in zip(gsum, g):
                    a.add_(b.float())
                lsum = lsum + loss_m
                psum = {k: psum[k] + parts_m[k] for k in psum}
            inv = 1.0 / M
            grads = [g * inv for g in gsum]
            loss = lsum * inv
            parts = {k: v * inv for k, v in psum.items()}
        # the reference decays every leaf of its scanned periods, where
        # stacking adds a dimension: norm scales and biases too
        decay = [n >= 2 for n in pytree.tree_leaves(jax_ndim(params, cfg))]
        params, opt_state, metrics = opt_mod.apply_updates(
            adamw, params, pytree.tree_unflatten(grads, spec), opt_state,
            pytree.tree_unflatten(decay, spec))
        metrics.update(loss=loss, **parts)
        return params, opt_state, metrics
    return train_step


def make_forward_step(cfg, opts: CallOpts = CallOpts()):
    def forward_step(params, batch):
        logits, _ = models.forward(params, cfg, batch, opts)
        return logits
    return forward_step


def make_prefill_step(cfg, kv_len: int, opts: CallOpts = CallOpts()):
    def prefill_step(params, batch):
        logits, cache = models.prefill(params, cfg, batch, kv_len, opts)
        return logits, cache
    return prefill_step


def make_decode_step(cfg, opts: CallOpts = CallOpts()):
    """``decode_step(params, tokens, pos, cache)``; ``pos`` a 0-d int32
    tensor or a Python int (``models.decode_step``). On the card
    ``PodEngine`` replays it as a captured CUDA graph
    (``serving/graphs.py``)."""
    def decode_step(params, tokens, pos, cache):
        return models.decode_step(params, cfg, tokens, pos, cache, opts=opts)
    return decode_step
