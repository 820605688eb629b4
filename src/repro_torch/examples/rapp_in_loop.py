"""RaPP-in-the-loop: the autoscaler driven by the TRAINED GNN predictor
vs the roofline oracle — the paper's full control loop, and what
prediction error costs at the platform level.

The port's twin of the JAX package's ``benchmarks/rapp_in_loop.py``. A
fast RaPP is trained on a compact corpus (olmo-1b, qwen2.5-3b, gemma-7b
at batches 1, 4, 8 and 16, 14 samples a graph, 600 steps, no holdout)
on ``cuda`` (the default) or, with ``--device cpu``, on the host, plugged
into ``HybridAutoScaler(predictor=...)`` and compared with the
oracle-driven scaler over qwen2.5-3b on the same trace
(``standard_workload(90 s, 20 rps, seed=3)``, a cluster of up to 48
GPUs). Prints cost per 1k requests, p95, the violations at 2x the SLO
and the simulator's wall for each arm.

Trained weights are cached under ``results/cache/`` keyed by every
training input (corpus, batches, samples, seed, steps, model config),
in a file of the port's own name, written to a temporary file and
renamed so an interrupted write never leaves a truncated cache;
``--retrain`` forces a fresh train.

Run:  PYTHONPATH=src python -m repro_torch.examples.rapp_in_loop \\
          [--device cpu] [--retrain]
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ARCHS
from repro_torch.core import (ClusterSimulator, FnSpec, HybridAutoScaler,
                              Reconfigurator, SimConfig)
from repro_torch.core.rapp import RaPPConfig, RaPPModel
from repro_torch.core.rapp import dataset as D, train as T
from repro_torch.device import resolve_device
from repro_torch.workloads import standard_workload

CORPUS = ("olmo-1b", "qwen2.5-3b", "gemma-7b")
BATCHES = (1, 4, 8, 16)
SAMPLES_PER_GRAPH = 14


@dataclasses.dataclass
class Arm:
    """One predictor's run: its metrics, the simulator's wall and whether
    the cluster's invariants held at the end."""
    cost_per_1k: float
    p95_ms: float
    viol_2x: float
    sim_wall_s: float
    invariant_ok: bool


def _cache_path(cache_dir, corpus, seed, steps) -> str:
    tag = repr(("rapp_in_loop_torch", [repr(c) for c in corpus], BATCHES,
                SAMPLES_PER_GRAPH, D.SMS, D.QUOTAS, seed, steps,
                T.TrainConfig(), RaPPConfig()))
    key = hashlib.blake2s(tag.encode(), digest_size=10).hexdigest()
    return os.path.join(cache_dir, f"rapp_torch_{key}.npz")


def train_rapp(seed: int = 0, train_steps: int = 600, retrain=False,
               cache_dir: str = "results/cache", device="cuda"):
    """Train (or load) the loop's RaPP on ``device``: (params, val MAPE,
    seconds spent, whether they came from the cache)."""
    corpus = [ARCHS[a] for a in CORPUS]
    dev = resolve_device(device)
    t0 = time.perf_counter()
    path = _cache_path(cache_dir, corpus, seed, train_steps)
    leaves, spec = pytree.tree_flatten(T.params_template(seed,
                                                         device="cpu"))
    if not retrain and os.path.exists(path):
        try:
            with np.load(path) as z:
                loaded = [z[f"arr_{i}"] for i in range(len(leaves))]
                mape = float(z["val_mape"])
            ok = all(a.shape == tuple(b.shape)
                     for a, b in zip(loaded, leaves))
        except Exception as e:  # a truncated or corrupt npz: retrain
            print(f"# ignoring unreadable weight cache {path}: {e}",
                  file=sys.stderr)
            ok = False
        if ok:
            params = pytree.tree_unflatten(
                [torch.from_numpy(a).to(dev) for a in loaded], spec)
            return params, mape, time.perf_counter() - t0, True
    ds = D.generate(corpus, batches=BATCHES,
                    samples_per_graph=SAMPLES_PER_GRAPH, seed=seed)
    tr, va, _ = D.split(ds, holdout_archs=())
    params = T.train(tr, va, cfg=T.TrainConfig(steps=train_steps,
                                               log_every=10**9),
                     verbose=False, device=dev)
    mape = T.evaluate(params, va)
    train_s = time.perf_counter() - t0
    os.makedirs(cache_dir, exist_ok=True)
    flat = [t.detach().cpu().numpy() for t in pytree.tree_leaves(params)]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, *flat, val_mape=np.float64(mape))
    os.replace(tmp, path)
    return params, mape, train_s, False


def run_arm(predictor, spec, arrivals, duration: float, base_rps: float,
            seed: int) -> Arm:
    """The hybrid autoscaler with ``predictor`` (None: the oracle) over
    ``spec`` through ``arrivals``, on a cluster of up to 48 GPUs."""
    recon = Reconfigurator(num_gpus=0, max_gpus=48)
    scaler = HybridAutoScaler(recon, predictor=predictor)
    t0 = time.perf_counter()
    scaler.prewarm(spec, base_rps)
    res = ClusterSimulator(spec, scaler, recon, arrivals,
                           SimConfig(duration_s=duration, seed=seed)).run()
    wall = time.perf_counter() - t0
    return Arm(res.cost_per_1k, res.pcts["p95"] * 1e3,
               res.violations([2.0])[2.0], wall, recon.invariant_ok())


def run(duration=90.0, base_rps=20.0, out=sys.stdout, seed=0,
        train_steps=600, retrain=False, device="cuda",
        cache_dir: str = "results/cache"):
    """-> (RaPP's cost per 1k x 1e6, the reference's derived string,
    {"oracle": Arm, "rapp": Arm, "val_mape", "train_s", "cached",
    "rapp_model"})."""
    spec = FnSpec(ARCHS["qwen2.5-3b"])
    params, mape, train_s, cached = train_rapp(seed, train_steps, retrain,
                                               cache_dir, device)
    rapp = RaPPModel(params, device=device)
    arr = standard_workload(duration, base_rps, seed=seed + 3)
    print("# RaPP-in-the-loop vs oracle predictor", file=out)
    print("predictor,cost_per_1k,p95_ms,viol@2x,sim_wall_s", file=out)
    arms = {}
    for name, predictor in [("oracle", None), ("rapp", rapp)]:
        a = run_arm(predictor, spec, arr, duration, base_rps, seed)
        print(f"{name},{a.cost_per_1k:.5f},{a.p95_ms:.1f},"
              f"{a.viol_2x:.4f},{a.sim_wall_s:.2f}", file=out)
        arms[name] = a
    o, r = arms["oracle"], arms["rapp"]
    derived = (f"rapp_val_mape={mape:.1f}%;"
               f"oracle_viol@2x={o.viol_2x:.3f};"
               f"rapp_viol@2x={r.viol_2x:.3f};"
               f"cost_ratio={r.cost_per_1k/max(o.cost_per_1k,1e-12):.2f}x;"
               f"train_wall_s={train_s:.2f};"
               f"rapp_sim_wall_s={r.sim_wall_s:.2f}")
    return r.cost_per_1k * 1e6, derived, dict(
        arms, val_mape=mape, train_s=train_s, cached=cached,
        rapp_model=rapp)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--retrain", action="store_true")
    args = ap.parse_args(argv)
    us, derived, _ = run(retrain=args.retrain, device=args.device)
    print(f"rapp_in_loop,{us:.2f},{derived}")


if __name__ == "__main__":
    main()
