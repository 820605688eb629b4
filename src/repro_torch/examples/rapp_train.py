"""Train RaPP and plug it into the autoscaler (paper's full control loop).

The port's twin of the JAX package's ``examples/rapp_train.py``.
Generates a latency corpus over five architectures at full width (the
port's extractor traces its own models, shapes only), trains the
GAT-based RaPP predictor on ``cuda`` (the default) or, with
``--device cpu``, on the CPU, reports its validation and test MAPE, then
drives the hybrid autoscaler with the LEARNED predictor instead of the
oracle. The dataset is made on the host, as the reference makes it.

Run:  PYTHONPATH=src python -m repro_torch.examples.rapp_train \\
          [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Tuple

from repro_torch.configs import ARCHS
from repro_torch.core import FnSpec, HybridAutoScaler, Reconfigurator
from repro_torch.core.rapp import RaPPModel
from repro_torch.core.rapp import dataset as D, train as T

CORPUS = ("olmo-1b", "qwen2.5-3b", "gemma-7b", "mamba2-2.7b",
          "deepseek-moe-16b")
BATCHES = (1, 4, 16)
SAMPLES_PER_GRAPH = 16
HOLDOUT = ("deepseek-moe-16b",)
STEPS = 800
RATES = (20, 60, 120, 30)


@dataclasses.dataclass
class RaPPRun:
    """The split, the trained params, the seconds ``train`` took (its
    validation passes included) and the MAPEs (%), the model and the
    cluster it scaled, and each rate's (pods as (sm, quota), the actions'
    kinds)."""
    splits: Tuple[D.Dataset, D.Dataset, D.Dataset]
    params: dict
    train_s: float
    val_mape: float
    test_mape: float
    rapp: RaPPModel
    recon: Reconfigurator
    steps: List[Tuple[float, list, list]]


def make_dataset(seed: int = 0):
    """(train, val, test): the reference example's corpus and split."""
    corpus = [ARCHS[a] for a in CORPUS]
    ds = D.generate(corpus, batches=BATCHES,
                    samples_per_graph=SAMPLES_PER_GRAPH, seed=seed)
    tr, va, te = D.split(ds, holdout_archs=HOLDOUT)
    print(f"dataset: {len(ds)} samples -> {len(tr)}/{len(va)}/{len(te)}")
    return tr, va, te


def autoscale(rapp: RaPPModel, rates=RATES):
    """The hybrid autoscaler over qwen2.5-3b, with ``rapp`` as its
    predictor, through ``rates``. Returns (cluster, each rate's record)."""
    spec = FnSpec(ARCHS["qwen2.5-3b"])
    recon = Reconfigurator(num_gpus=0, max_gpus=8)
    scaler = HybridAutoScaler(recon, predictor=rapp)
    scaler.prewarm(spec, expected_rps=20.0)
    steps = []
    for t, rps in enumerate(rates):
        acts = scaler.scale(float(t * 25), spec, float(rps))
        pods = [(p.sm, round(p.quota, 2)) for p in recon.pods_of(spec.fn_id)]
        kinds = [a.kind for a in acts]
        print(f"R={rps:4.0f} rps -> pods={pods} actions={kinds}")
        steps.append((float(rps), pods, kinds))
    print("RaPP-driven autoscaling complete; invariants:",
          recon.invariant_ok())
    return recon, steps


def run(device="cuda", steps: int = STEPS, splits=None) -> RaPPRun:
    tr, va, te = splits or make_dataset()
    t0 = time.perf_counter()
    params = T.train(tr, va, cfg=T.TrainConfig(steps=steps, log_every=200),
                     device=device)
    train_s = time.perf_counter() - t0   # its last evaluation synchronises
    print(f"trained {steps} steps in {train_s:.2f} s "
          f"({steps / train_s:.1f} steps/s, validation passes included)")
    val, test = T.evaluate(params, va), T.evaluate(params, te)
    print(f"RaPP  val MAPE={val:.2f}%  "
          f"test (incl. unseen arch) MAPE={test:.2f}%")
    rapp = RaPPModel(params, device=device)
    recon, record = autoscale(rapp)
    return RaPPRun((tr, va, te), params, train_s, val, test, rapp, recon,
                   record)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
