"""RaPP training loop (the port's AdamW over the GAT+MLP predictor).

The counterpart of the JAX package's ``core/rapp/train.py``: the same
loss ``mean((logl - labels)^2)``, the same numpy batch draw from
``cfg.seed``, ``AdamWConfig(lr, warmup_steps=50, total_steps=steps,
weight_decay=0.01)`` with its default decay rule (leaves of two or more
dimensions: RaPP's tree is not stacked, so this is the reference's
rule), validation every ``max(steps // 8, 50)`` steps and the best
params on the validation set kept. The dataset stays on the host as
numpy; each batch is sent to ``device`` (``cuda`` unless the caller
passes ``"cpu"``), where the step runs.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.rapp import predictor as P
from repro_torch.device import resolve_device
from repro_torch.training import optimizer as opt_mod


@dataclasses.dataclass
class TrainConfig:
    lr: float = 1e-3
    steps: int = 1500
    batch_size: int = 64
    seed: int = 0
    log_every: int = 200


def _batch_of(ds, idx, device):
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a[idx])).to(device)
    return {"node_feats": put(ds.node_feats), "adj": put(ds.adj),
            "mask": put(ds.mask), "global": put(ds.global_feats),
            "prior": put(ds.priors)}


def _device_of(params):
    return pytree.tree_leaves(params)[0].device


def params_template(seed: int = 0,
                    rapp_cfg: P.RaPPConfig = P.RaPPConfig(), device="cuda"):
    """Parameter tree with the training-time structure — used to
    restore checkpoints saved as flattened leaves."""
    return P.init_params(seed, rapp_cfg, device)


def mape(pred_ms: np.ndarray, true_ms: np.ndarray) -> float:
    return float(np.mean(np.abs(pred_ms - true_ms)
                         / np.maximum(true_ms, 1e-6)) * 100.0)


@torch.no_grad()
def evaluate(params, ds, batch_size: int = 256) -> float:
    dev = _device_of(params)
    preds = []
    for i in range(0, len(ds), batch_size):
        idx = np.arange(i, min(i + batch_size, len(ds)))
        b = _batch_of(ds, idx, dev)
        preds.append(P.predict_latency_ms(params, b).cpu().numpy())
    pred_ms = np.concatenate(preds)
    true_ms = np.expm1(ds.labels_logms)
    return mape(pred_ms, true_ms)


def loss_fn(params, batch, labels):
    logl = P.forward_batch(params, batch["node_feats"], batch["adj"],
                           batch["mask"], batch["global"], batch["prior"])
    return torch.mean((logl - labels) ** 2)


def loss_and_grads(params, batch, labels):
    """(loss, gradients in a tree like ``params``) of the train loss at
    ``params``, which are left as they are."""
    flat, spec = pytree.tree_flatten(params)
    work = [t.detach().requires_grad_() for t in flat]
    with torch.enable_grad():
        loss = loss_fn(pytree.tree_unflatten(work, spec), batch, labels)
        grads = torch.autograd.grad(loss, work)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def make_step(adamw: opt_mod.AdamWConfig):
    """(params, opt state, batch, labels) -> (params, opt state, loss):
    one AdamW step on the loss's gradients."""
    def step(params, state, batch, labels):
        loss, grads = loss_and_grads(params, batch, labels)
        params, state, _ = opt_mod.apply_updates(adamw, params, grads, state)
        return params, state, loss
    return step


def train(train_ds, val_ds, rapp_cfg: P.RaPPConfig = P.RaPPConfig(),
          cfg: TrainConfig = TrainConfig(), verbose: bool = True,
          device="cuda"):
    """The best params on ``val_ds``, trained from
    ``init_params(cfg.seed)`` on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    params = P.init_params(cfg.seed, rapp_cfg, dev)
    adamw = opt_mod.AdamWConfig(lr=cfg.lr, warmup_steps=50,
                                total_steps=cfg.steps, weight_decay=0.01)
    opt_state = opt_mod.init_opt_state(params)
    step = make_step(adamw)

    n = len(train_ds)
    t0 = time.time()
    best_params, best_val = params, float("inf")
    eval_every = max(cfg.steps // 8, 50)
    for i in range(cfg.steps):
        idx = rng.choice(n, size=min(cfg.batch_size, n), replace=False)
        batch = _batch_of(train_ds, idx, dev)
        labels = torch.from_numpy(train_ds.labels_logms[idx]).to(dev)
        params, opt_state, loss = step(params, opt_state, batch, labels)
        if (i % eval_every == 0 or i == cfg.steps - 1) and len(val_ds):
            vm = evaluate(params, val_ds)
            if vm < best_val:
                best_val = vm
                best_params = pytree.tree_map(torch.clone, params)
            if verbose and (i % cfg.log_every == 0 or i == cfg.steps - 1):
                print(f"step {i:5d} loss={float(loss):.4f} "
                      f"val_MAPE={vm:.2f}% (best {best_val:.2f}%) "
                      f"({time.time()-t0:.0f}s)", flush=True)
    return best_params
