"""Single-function cluster simulator for serverless inference auto-scaling.

A copy of the JAX package's ``core/simulator.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

Physics: request arrivals (workload trace) -> gateway load balancer
(throughput-weighted, paper §3) -> per-pod queues -> window-quantized
execution on each pod's (sm, quota) allocation (the vTPU time-token
scheduler's observable behavior, perf_model.latency) -> completion records.

The auto-scaling policy (HAS hybrid / KServe-like / FaST-GShare-like) runs
every ``autoscale_interval_s`` on the observed request rate, mutating the
same Reconfigurator cluster state. Cost and SLO metrics integrate over the
run.

This is a thin wrapper over the discrete-event engine in
``core/events.py`` (heap-scheduled arrivals / batch timeouts / pod-free /
autoscale-timer events) — orders of magnitude faster than scanning a
20 ms tick over the trace. The original tick engine survives as
``core/simulator_tick.py`` and the parity test
(``tests/test_event_parity.py``) pins the two engines together.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core import perf_model
from repro_torch.core.cost import CostMeter
from repro_torch.core.events import (EventEngine, FunctionState, PodRuntime,
                               SimConfig)
from repro_torch.core.metrics import baseline_batch_of
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.reconfigurator import Reconfigurator
from repro_torch.core.slo import Request, percentiles, violation_rates

__all__ = ["ClusterSimulator", "PodRuntime", "SimConfig", "SimResult",
           "result_from_state"]


@dataclasses.dataclass
class SimResult:
    latencies: np.ndarray
    n_arrived: int
    n_completed: int
    n_dropped: int
    cost_usd: float
    cost_per_1k: float
    baseline_s: float
    pcts: dict
    pod_seconds: float
    timeline: list
    cold_starts: int = 0
    action_counts: dict = dataclasses.field(default_factory=dict)

    def violations(self, multipliers):
        lat = self.latencies
        # dropped requests count as violations at every multiplier
        pad = np.full(self.n_dropped, np.inf)
        return violation_rates(np.concatenate([lat, pad]),
                               self.baseline_s, multipliers)


def result_from_state(st: FunctionState, cost: CostMeter,
                      baseline_batch: int = 8) -> SimResult:
    """Fold a drained FunctionState into the stable SimResult API."""
    lats = np.array([r.latency for r in st.completed
                     if r.latency is not None])
    # stream-metrics runs fold completions into the engine's sink
    # instead of retaining them: the count survives on the state
    n_comp = len(lats) + getattr(st, "stream_n_completed", 0)
    base = perf_model.slo_baseline(st.spec, baseline_batch)
    return SimResult(
        latencies=lats, n_arrived=len(st.arrivals), n_completed=n_comp,
        n_dropped=st.dropped, cost_usd=cost.total_usd,
        cost_per_1k=cost.per_1k_requests(n_comp),
        baseline_s=base, pcts=percentiles(lats),
        pod_seconds=cost.gpu_seconds, timeline=st.timeline,
        cold_starts=st.cold_starts, action_counts=dict(st.action_counts))


class ClusterSimulator:
    def __init__(self, spec: FnSpec, policy, recon: Reconfigurator,
                 arrivals: np.ndarray, cfg: SimConfig = SimConfig(),
                 engine_cls=EventEngine):
        """arrivals: sorted array of request arrival times (seconds).
        ``engine_cls`` swaps the event engine (the scalar reference
        ``core/engine_scalar.py`` for parity/benchmark runs)."""
        self.spec = spec
        self.policy = policy
        self.recon = recon
        self.arrivals = arrivals
        self.cfg = cfg
        self.cost = CostMeter(whole_gpu=cfg.whole_gpu_cost)
        self.state = FunctionState(spec, policy, arrivals)
        self.engine = engine_cls(recon, cfg, [self.state], cost=self.cost,
                                 rng=np.random.default_rng(cfg.seed),
                                 track_peak=True)

    # introspection used by tests/tools; delegates to the engine state
    @property
    def queue(self):
        return self.state.queue

    @property
    def completed(self) -> List[Request]:
        return self.state.completed

    @property
    def dropped(self) -> int:
        return self.state.dropped

    @property
    def runtimes(self) -> Dict[str, PodRuntime]:
        return self.state.runtimes

    @property
    def timeline(self) -> list:
        return self.state.timeline

    @property
    def peak_gpus(self) -> int:
        return self.engine.peak_gpus

    def run(self) -> SimResult:
        self.engine.run()
        return result_from_state(self.state, self.cost,
                                 baseline_batch_of(self.policy))
