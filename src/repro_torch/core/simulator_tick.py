"""Reference tick-scanned cluster simulator (the first engine, slimmed).

A copy of the JAX package's ``core/simulator_tick.py``, imports
rewritten; ``tests/test_torch_control_plane.py`` holds the code after
this docstring equal to it.

Scans a fixed ``tick_s`` clock over the whole trace: per tick it injects
arrivals, sheds aged requests, runs the autoscaler on schedule, and lets
idle pods pull batches. Kept as the semantic reference for the
discrete-event engine (``core/events.py``): the parity test
(``tests/test_torch_tick_parity.py``) runs both on the same seeded trace
and pins conservation, completion counts, and latency/cost metrics
together. O(duration / tick_s) regardless of load, so use the event
engine for anything but short parity traces.
"""
from __future__ import annotations

from collections import deque
from typing import Dict

import numpy as np

from repro_torch.core import perf_model
from repro_torch.core.cost import CostMeter
from repro_torch.core.perf_model import FnSpec
from repro_torch.core.reconfigurator import Reconfigurator
from repro_torch.core.metrics import baseline_batch_of
from repro_torch.core.simulator import PodRuntime, SimConfig, SimResult
from repro_torch.core.slo import Request, percentiles


class TickClusterSimulator:
    """Single-function simulator quantized to ``cfg.tick_s``."""

    def __init__(self, spec: FnSpec, policy, recon: Reconfigurator,
                 arrivals: np.ndarray, cfg: SimConfig = SimConfig()):
        self.spec = spec
        self.policy = policy
        self.recon = recon
        self.arrivals = arrivals
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.runtimes: Dict[str, PodRuntime] = {}
        self.queue: deque = deque()  # shared per-function FIFO (pull model)
        self.completed = []
        self.dropped = 0
        self.cost = CostMeter(whole_gpu=cfg.whole_gpu_cost)
        self.timeline: list = []

    # ---- execution ----------------------------------------------------------
    # Pull-based dispatch (OpenFaaS queue-worker semantics): idle ready pods
    # pull up to `batch` requests from the shared function queue; the
    # highest-capacity pods pull first (the gateway's throughput-weighted
    # distribution emerges from pull order + service rates).
    def _execute(self, now: float):
        pods = {p.pod_id: p for p in self.recon.pods_of(self.spec.fn_id)}
        for pid in list(self.runtimes):
            if pid not in pods:
                rt = self.runtimes.pop(pid)
                for r in rt.inflight:  # inflight on a removed pod completes
                    r.completion = rt.busy_until
                    self.completed.append(r)
        order = sorted(
            pods.values(),
            key=lambda p: -perf_model.throughput(self.spec, p.batch, p.sm,
                                                 p.quota))
        for pod in order:
            rt = self.runtimes.setdefault(pod.pod_id, PodRuntime(pod.pod_id))
            if rt.busy_until > now:
                continue
            if rt.inflight:
                for r in rt.inflight:
                    r.completion = rt.busy_until
                self.completed.extend(rt.inflight)
                rt.inflight = []
            if not self.queue or pod.ready_at > now:
                continue
            # batch formation: run when full or the head waited long enough
            if (len(self.queue) < pod.batch
                    and now - self.queue[0].arrival < self.cfg.batch_wait_s):
                continue
            take = min(pod.batch, len(self.queue))
            batch = [self.queue.popleft() for _ in range(take)]
            service = perf_model.latency(self.spec, take, pod.sm, pod.quota,
                                         window_ms=self.recon.window_ms,
                                         rng=self.rng)
            for r in batch:
                r.start = now
            rt.busy_until = now + service
            rt.inflight = batch

    # ---- main loop ------------------------------------------------------------
    def run(self) -> SimResult:
        cfg = self.cfg
        t, ai = 0.0, 0
        n = len(self.arrivals)
        last_scale = -1e9
        window_arrivals = deque()
        while t < cfg.duration_s or ai < n or self._work_left():
            if t > cfg.duration_s + cfg.drop_after_s:
                break
            # arrivals
            while ai < n and self.arrivals[ai] <= t:
                req = Request(self.spec.fn_id, float(self.arrivals[ai]))
                window_arrivals.append(req.arrival)
                self.queue.append(req)
                ai += 1
            # shed requests that aged out in queue
            while self.queue and t - self.queue[0].arrival > cfg.drop_after_s:
                self.queue.popleft()
                self.dropped += 1
            # autoscaler: observed load = arrival rate + backlog drain demand
            # (queued work is gateway-visible and must be scheduled too)
            if t - last_scale >= cfg.autoscale_interval_s:
                while window_arrivals and window_arrivals[0] < t - 5.0:
                    window_arrivals.popleft()
                observed = len(window_arrivals) / max(min(t, 5.0), 1e-9) \
                    if t > 0 else 0.0
                observed += len(self.queue) / 5.0
                self.policy.tick(t, self.spec, observed)
                last_scale = t
                self.timeline.append(
                    (t, observed, len(self.recon.pods_of(self.spec.fn_id)),
                     sum((p.sm / 8.0) * p.quota
                         for p in self.recon.pods_of(self.spec.fn_id))))
            # execution + cost
            self._execute(t)
            self.cost.accrue(self.recon, cfg.tick_s)
            t += cfg.tick_s

        # flush remaining inflight
        for rt in self.runtimes.values():
            for r in rt.inflight:
                r.completion = rt.busy_until
                self.completed.append(r)
        self.dropped += len(self.queue)

        lats = np.array([r.latency for r in self.completed
                         if r.latency is not None])
        base = perf_model.slo_baseline(self.spec,
                                       baseline_batch_of(self.policy))
        return SimResult(
            latencies=lats, n_arrived=n, n_completed=len(lats),
            n_dropped=self.dropped, cost_usd=self.cost.total_usd,
            cost_per_1k=self.cost.per_1k_requests(len(lats)),
            baseline_s=base, pcts=percentiles(lats),
            pod_seconds=self.cost.gpu_seconds, timeline=self.timeline)

    def _work_left(self) -> bool:
        if self.queue:
            return True
        return any(r.inflight for r in self.runtimes.values())
