"""Training launcher: the counterpart of the JAX package's
``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 100 [--batch 8 --seq 256 --lr 6e-4 --ckpt path.npz] \\
      [--device cpu] [--dry-run [--multi-pod] --shape train_4k]

On the card (the default) it trains the arch at full width with random
weights; with ``--device cpu`` it takes ``reduced(cfg)``, as the
reference does on a CPU backend. AdamW warms up over a tenth of the
steps and decays over all of them; the data is ``SyntheticLMData(seed=1)``;
the step is ``make_train_step(..., CallOpts(remat=True))``. ``--ckpt``
writes the params in the JAX package's npz format. ``--dry-run`` plans
the ``--shape`` step on the production mesh instead (``dryrun.run_combo``:
16x16, or 2x16x16 with ``--multi-pod``) and trains nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import ArchConfig, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import CallOpts
from repro_torch.training import (checkpoint, data as data_mod,
                                  optimizer as opt_mod)
from repro_torch.training.steps import make_train_step


@dataclasses.dataclass
class TrainRun:
    """A finished run: the model, its final params and optimizer state,
    each step's metrics as floats, and each step's wall time in seconds
    (host clock around the step, ending in a device synchronize)."""
    cfg: ArchConfig
    params: dict
    opt_state: opt_mod.OptState
    metrics: List[dict]
    step_s: List[float]


def batch_at(cfg, ds, step: int, batch: int, seq: int, device):
    """The reference launcher's batch of ``step``: tokens from ``ds``, and
    bf16 normal frame or visual embeddings seeded by the step."""
    out = {"tokens": torch.as_tensor(ds.batch(step, batch, seq)["tokens"],
                                     device=device)}
    rng = np.random.default_rng(step)
    if cfg.is_encoder_decoder:
        out["frame_embeds"] = torch.as_tensor(rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)), device=device).bfloat16()
    if cfg.num_visual_tokens:
        out["visual_embeds"] = torch.as_tensor(rng.standard_normal(
            (batch, cfg.num_visual_tokens, cfg.d_model)),
            device=device).bfloat16()
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, adamw: opt_mod.AdamWConfig, *, steps: int, batch: int,
          seq: int, device="cuda", seed: int = 0, log_every: int = 0,
          log=print) -> TrainRun:
    """Train ``cfg`` from random weights (``seed``) for ``steps`` steps on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``), logging
    every ``log_every`` steps (0: a tenth of them) and the last."""
    device = resolve_device(device)
    train_step = make_train_step(cfg, adamw, CallOpts(remat=True))
    params = models.init_params(cfg, seed=seed, device=device)
    opt_state = opt_mod.init_opt_state(params, adamw.moment_dtype)
    ds = data_mod.SyntheticLMData(cfg.vocab_size, seed=1)
    metrics, step_s = [], []
    log_every = log_every or max(steps // 10, 1)
    t0 = time.perf_counter()
    for step in range(steps):
        host = batch_at(cfg, ds, step, batch, seq, device)
        _sync(device)
        t = time.perf_counter()
        params, opt_state, m = train_step(params, opt_state, host)
        _sync(device)
        step_s.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
        if step % log_every == 0 or step == steps - 1:
            m = metrics[-1]
            log(f"step {step:5d} loss={m['loss']:.4f} lr={m['lr']:.2e} "
                f"gnorm={m['grad_norm']:.2f} ({time.perf_counter() - t0:.0f}s)")
    return TrainRun(cfg, params, opt_state, metrics, step_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.dry_run:
        from repro_torch.launch.dryrun import run_combo
        return run_combo(args.arch, args.shape, multi_pod=args.multi_pod)
    cfg = get_config(args.arch)
    if resolve_device(args.device).type == "cpu":
        cfg = reduced(cfg)
        print(f"[train] using reduced {cfg.name} "
              f"({cfg.param_count() / 1e6:.1f}M params) on {args.device}")
    adamw = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=args.steps // 10,
                                total_steps=args.steps)
    run = train(cfg, adamw, steps=args.steps, batch=args.batch, seq=args.seq,
                device=args.device)
    if args.ckpt:
        checkpoint.save(args.ckpt, {"params": run.params}, cfg)
        print(f"checkpoint -> {args.ckpt}")
    return run


if __name__ == "__main__":
    main()
