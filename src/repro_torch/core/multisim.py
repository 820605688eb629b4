"""Multi-function co-located simulation (paper §4: the MLPerf-derived
function benchmark runs simultaneously on one 10-GPU cluster).

A copy of the JAX package's ``core/multisim.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

Runs N functions through the shared discrete-event engine
(``core/events.py``) against one Reconfigurator — so functions compete
for chips and pack under SM alignment / HGO placement — with a single
cluster-level cost meter integrated between events.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.cost import CostMeter
from repro_torch.core.events import EventEngine, FunctionState, SimConfig
from repro_torch.core.metrics import baseline_batch_of
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.reconfigurator import Reconfigurator
from repro_torch.core.simulator import SimResult, result_from_state


@dataclasses.dataclass
class MultiSimResult:
    per_fn: Dict[str, SimResult]
    cluster_cost_usd: float
    cluster_cost_per_1k: float
    peak_gpus: int


class MultiFunctionSimulator:
    """Co-simulates several functions against one cluster."""

    def __init__(self, specs: List[FnSpec], policies, recon: Reconfigurator,
                 arrivals: Dict[str, np.ndarray],
                 cfg: SimConfig = SimConfig(), engine_cls=EventEngine):
        self.cfg = cfg
        self.recon = recon
        self.cost = CostMeter(whole_gpu=cfg.whole_gpu_cost)
        self.states = [FunctionState(spec, policies[spec.fn_id],
                                     arrivals[spec.fn_id])
                       for spec in specs]
        self.engine = engine_cls(recon, cfg, self.states, cost=self.cost,
                                 rng=np.random.default_rng(cfg.seed),
                                 track_peak=True)

    @property
    def peak_gpus(self) -> int:
        return self.engine.peak_gpus

    def run(self) -> MultiSimResult:
        self.engine.run()
        per_fn = {}
        total_completed = 0
        zero_cost = CostMeter()  # per-fn cost is cluster-level, not split
        for st in self.states:
            per_fn[st.fn_id] = result_from_state(
                st, zero_cost, baseline_batch_of(st.policy))
            total_completed += per_fn[st.fn_id].n_completed
        return MultiSimResult(
            per_fn=per_fn, cluster_cost_usd=self.cost.total_usd,
            cluster_cost_per_1k=(self.cost.total_usd / total_completed * 1e3
                                 if total_completed else float("inf")),
            peak_gpus=self.engine.peak_gpus)
