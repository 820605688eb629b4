"""Train a ~100M-param dense LM for a few hundred steps. The port's twin
of the JAX package's ``examples/train_small.py``.

Exercises the full training substrate: config -> model -> synthetic data
pipeline -> AdamW + cosine schedule -> checkpointing (the JAX package's
npz format). On ``cuda`` (the default) or, with ``--device cpu``, on the
CPU; the model is the same olmo-family cut (8 layers, d_model 768) on
either.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_small \\
          [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import ARCHS
from repro_torch.launch.train import train
from repro_torch.training import checkpoint, optimizer as opt_mod

# ~100M params: olmo-family, 8 layers, d_model 768
CFG = dataclasses.replace(
    ARCHS["olmo-1b"], name="olmo-100m", num_layers=8, d_model=768,
    num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=32768)
CKPT = "results/olmo-100m.npz"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"model: {CFG.name}  params~{CFG.param_count() / 1e6:.0f}M")
    adamw = opt_mod.AdamWConfig(lr=6e-4, warmup_steps=20,
                                total_steps=args.steps)
    run = train(CFG, adamw, steps=args.steps, batch=8, seq=256,
                device=args.device, log_every=20)
    checkpoint.save(CKPT, {"params": run.params}, CFG)
    print(f"checkpoint written to {CKPT}")
    return run


if __name__ == "__main__":
    main()
