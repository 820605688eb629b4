"""Fig. 5 — RaPP vs the DIPPM-style static-only predictor: MAPE on the
validation set (seen archs, unseen configs) and on the test set (unseen
configs and the fully unseen gemma-7b and deepseek-moe-16b).

The port's twin of the JAX package's ``benchmarks/fig5_rapp_accuracy.py``:
the same corpus (``build_corpus``, one synthetic variant a family in
quick mode and two with ``--full``), ONE featurized dataset whose
static-only copy zeroes the runtime columns (``NODE_STATIC_F`` onwards of
the node features, ``GLOBAL_STATIC_F`` onwards of the global ones) and
the priors, the same split, and RaPP and DIPPM trained on ``cuda`` (the
default) or, with ``--device cpu``, on the host, for 1200 steps (3000
with ``--full``). The dataset is made on the host, as the reference makes
it. Prints the reference script's CSV lines. Paper: RaPP ~5% MAPE, stable
on unseen models; DIPPM degrades 10.1 -> 17.7%.

Run:  PYTHONPATH=src python -m repro_torch.examples.rapp_accuracy \\
          [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

from repro_torch.core.rapp import dataset as D, features as F
from repro_torch.core.rapp import predictor as P, train as T
from repro_torch.device import resolve_device


def static_only(ds: D.Dataset) -> D.Dataset:
    """The DIPPM copy of ``ds``: its rows with the runtime-feature
    columns and the priors zeroed."""
    nf = np.array(ds.node_feats)
    nf[:, :, F.NODE_STATIC_F:] = 0.0
    gf = np.array(ds.global_feats)
    gf[:, F.GLOBAL_STATIC_F:] = 0.0
    return dataclasses.replace(ds, node_feats=nf, global_feats=gf,
                               priors=np.zeros_like(ds.priors))


def run(quick: bool = True, out=sys.stdout, seed: int = 0, device="cuda"):
    """-> (RaPP's test MAPE, the reference's derived string, results).
    ``results[name]`` holds each model's ``val_mape``, ``test_mape``,
    ``n_train``, ``n_test`` and ``train_s`` (seconds in ``train``, its
    validation passes included); ``results["_rapp_params"]`` RaPP's
    params."""
    device = resolve_device(device)   # before minutes of dataset work
    t0 = time.time()
    corpus = D.build_corpus(n_variants_per_arch=1 if quick else 2, seed=seed)
    batches = (1, 4, 16) if quick else D.BATCHES
    spg = 16 if quick else 30
    steps = 1200 if quick else 3000
    ds_full = D.generate(corpus, batches=batches, samples_per_graph=spg,
                         seed=seed, with_runtime=True)
    ds_static = static_only(ds_full)
    results = {}
    for name, with_rt, ds in [("rapp", True, ds_full),
                              ("dippm", False, ds_static)]:
        tr, va, te = D.split(ds)
        t1 = time.perf_counter()
        params = T.train(
            tr, va, rapp_cfg=P.RaPPConfig(with_runtime=with_rt),
            cfg=T.TrainConfig(steps=steps, log_every=max(steps // 3, 1)),
            verbose=not quick, device=device)
        train_s = time.perf_counter() - t1   # its last evaluation syncs
        results[name] = {"val_mape": T.evaluate(params, va),
                         "test_mape": T.evaluate(params, te),
                         "n_train": len(tr), "n_test": len(te),
                         "train_s": train_s}
        if name == "rapp":
            results["_rapp_params"] = params
    r, d = results["rapp"], results["dippm"]
    print(f"# Fig5 RaPP accuracy ({time.time()-t0:.0f}s, "
          f"{r['n_train']} train / {r['n_test']} test)", file=out)
    print("model,val_mape_pct,test_mape_pct", file=out)
    print(f"rapp,{r['val_mape']:.2f},{r['test_mape']:.2f}", file=out)
    print(f"dippm,{d['val_mape']:.2f},{d['test_mape']:.2f}", file=out)
    derived = (f"rapp_test={r['test_mape']:.1f}%;"
               f"dippm_test={d['test_mape']:.1f}%;"
               f"gap={d['test_mape']/max(r['test_mape'],1e-9):.2f}x")
    return r["test_mape"], derived, results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mape, derived, _ = run(quick=not args.full, device=args.device)
    print(f"fig5_rapp_accuracy,{mape:.2f},{derived}")


if __name__ == "__main__":
    main()
