"""RaPP latency dataset generation.

A copy of the JAX package's ``core/rapp/dataset.py``, imports rewritten:
the graphs come from the port's extractor and ``calibration`` is the
port's ``repro_torch.profiling.CalibrationTable``.

The paper profiles all official PyTorch models under various (batch, SM,
quota) configs: 53,400 samples split 42,720 / 5,340 / 5,340. Our model zoo
is the 10 assigned architectures plus synthetic same-family variants
(depth/width jittered) for diversity. Labels are noisy measurements of the
roofline oracle (the simulator's physics). The test split holds out BOTH
unseen configurations and entire unseen architectures (paper §4.2 tests
"unseen configurations and models").
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional

import numpy as np

from repro_torch.configs import ARCHS, ArchConfig, reduced
from repro_torch.configs.gpus import DEFAULT_GPU_TYPE, get_gpu_type
from repro_torch.core import perf_model
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.rapp import features as F

BATCHES = (1, 2, 4, 8, 16, 32)
SMS = (1, 2, 3, 4, 5, 6, 7, 8)
QUOTAS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def _variant(cfg: ArchConfig, rng: np.random.Generator) -> ArchConfig:
    """Same-family synthetic variant (diversifies the training corpus)."""
    import dataclasses as dc
    scale = float(rng.choice([0.5, 0.75, 1.25, 1.5]))
    layers = max(2, int(cfg.num_layers * float(rng.choice([0.25, 0.5, 0.75]))))
    d_model = int(cfg.d_model * scale) // 128 * 128 or 128
    heads = max(1, cfg.num_heads)
    updates = dict(num_layers=layers, d_model=d_model,
                   name=f"{cfg.name}-var{layers}x{d_model}")
    if cfg.d_ff:
        updates["d_ff"] = int(cfg.d_ff * scale) // 128 * 128 or 256
    return dc.replace(cfg, **updates)


def build_corpus(n_variants_per_arch: int = 2, seed: int = 0
                 ) -> List[ArchConfig]:
    rng = np.random.default_rng(seed)
    corpus = list(ARCHS.values())
    for cfg in list(ARCHS.values()):
        for _ in range(n_variants_per_arch):
            try:
                corpus.append(_variant(cfg, rng))
            except Exception:
                pass
    return corpus


@dataclasses.dataclass
class Dataset:
    node_feats: np.ndarray
    adj: np.ndarray
    mask: np.ndarray
    global_feats: np.ndarray
    priors: np.ndarray
    labels_logms: np.ndarray
    arch_names: np.ndarray

    def __len__(self):
        return len(self.labels_logms)

    def subset(self, idx):
        return Dataset(self.node_feats[idx], self.adj[idx], self.mask[idx],
                       self.global_feats[idx], self.priors[idx],
                       self.labels_logms[idx], self.arch_names[idx])


def generate(corpus: Optional[List[ArchConfig]] = None,
             batches=BATCHES, sms=SMS, quotas=QUOTAS,
             samples_per_graph: int = 24, seed: int = 0,
             with_runtime: bool = True, verbose: bool = False,
             gpu_types=(DEFAULT_GPU_TYPE,), calibration=None) -> Dataset:
    """Sample (arch, batch) graphs x random (sm, quota) configs.

    ``gpu_types`` widens the corpus across device classes: each sampled
    config is measured (features AND label) on one of the given types,
    so a single model learns the cross-device latency surface via the
    device-descriptor features. The default single-reference tuple
    reproduces the legacy dataset exactly.

    ``calibration`` (a ``repro_torch.profiling.CalibrationTable``) replaces
    the oracle label with the MEASURED latency for every sampled config
    the table covers — the paper's setting, where RaPP trains on models
    profiled on hardware. Configs the table misses keep the noisy
    oracle label, so a partial profile still yields a full dataset."""
    rng = np.random.default_rng(seed)
    corpus = corpus or build_corpus()
    gpu_types = [get_gpu_type(t) for t in gpu_types]
    rows = {k: [] for k in ("node_feats", "adj", "mask", "global", "prior")}
    labels, names = [], []
    for cfg in corpus:
        for b in batches:
            try:
                graph = F.extract_graph(cfg, b)
            except Exception as e:
                if verbose:
                    print(f"skip {cfg.name} b={b}: {e}")
                continue
            spec = FnSpec(cfg)
            n_rows = 0
            for gpu in gpu_types:
                # configs wider than the device saturate at its width
                dev_sms = tuple(min(s, gpu.sm_total) for s in sms)
                combos = sorted(set(itertools.product(dev_sms, quotas)))
                pick = rng.choice(len(combos),
                                  size=min(samples_per_graph, len(combos)),
                                  replace=False)
                for ci in pick:
                    sm, q = combos[ci]
                    t = F.tensorize(graph, spec, b, sm, q, rng,
                                    with_runtime=with_runtime, gpu=gpu)
                    label = None
                    if calibration is not None:
                        label = calibration.latency(spec, b, sm, q,
                                                    gpu=gpu)
                    if label is None:
                        label = perf_model.latency(spec, b, sm, q,
                                                   rng=rng, gpu=gpu)
                    for k in rows:
                        rows[k].append(t[k])
                    labels.append(np.log1p(label * 1e3))  # log(ms)
                    names.append(cfg.name)
                n_rows += len(pick)
            if verbose:
                print(f"{cfg.name} b={b}: {n_rows} samples", flush=True)
    return Dataset(
        node_feats=np.stack(rows["node_feats"]),
        adj=np.stack(rows["adj"]),
        mask=np.stack(rows["mask"]),
        global_feats=np.stack(rows["global"]),
        priors=np.array(rows["prior"], np.float32),
        labels_logms=np.array(labels, np.float32),
        arch_names=np.array(names))


def split(ds: Dataset, holdout_archs=("gemma-7b", "deepseek-moe-16b"),
          val_frac: float = 0.1, seed: int = 0):
    """Train/val/test: test = unseen archs + random unseen configs."""
    rng = np.random.default_rng(seed)
    is_holdout = np.isin(ds.arch_names, holdout_archs)
    rest = np.where(~is_holdout)[0]
    rng.shuffle(rest)
    n_val = int(len(rest) * val_frac)
    n_test_cfg = int(len(rest) * val_frac)
    val_idx = rest[:n_val]
    test_cfg_idx = rest[n_val:n_val + n_test_cfg]
    train_idx = rest[n_val + n_test_cfg:]
    test_idx = np.concatenate([np.where(is_holdout)[0], test_cfg_idx])
    return ds.subset(train_idx), ds.subset(val_idx), ds.subset(test_idx)
