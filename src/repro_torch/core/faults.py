"""Fault injection + graceful degradation (the chaos layer).

A copy of the JAX package's ``core/faults.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

The event engine (``core/events.py``) can run under a composable
``FaultModel`` describing four discrete fault processes, each drawn
from its OWN dedicated seeded rng stream (the spot-reclaim template:
service noise and reclaim draws are untouched, so fault-free runs stay
bitwise identical to every legacy golden trace):

  * **chip hard-failure** — a live chip dies instantly (no grace
    window, unlike a spot ``RECLAIM_NOTICE``): in-flight batches are
    killed on the spot and the chip leaves through the same
    ``remove_gpu`` plumbing a reclaim kill uses;
  * **transient straggler** — a pod's service times inflate by
    ``straggler_factor`` for ``straggler_duration_s`` (a noisy
    neighbor, thermal throttle, or failing HBM stack);
  * **host-cache loss** — one node's host-RAM weight cache drops
    (``ModelStateTracker.drop_node_cache``): every model cached there
    demotes to COLD, so the next start on that node pays the full
    object-store fetch;
  * **control-plane blackout** — autoscale timers fire but the policy
    is unreachable for ``blackout_duration_s``: no scaling decisions,
    no replacement capacity, while dispatch keeps serving.

The resilience half (``ResilienceConfig``) is the degradation
machinery a production gateway pairs with that chaos:

  * **deadlines + bounded retries** — every request carries an implicit
    deadline (``arrival + deadline_s``); a batch killed mid-flight is
    requeued at the queue head only while its requests have retry
    budget left AND can still meet their deadlines (generalizing the
    boolean ``SimConfig.reclaim_requeue`` into a first-class retry
    policy with backoff-aware requeue accounting);
  * **health scoring + quarantine** — a per-pod EWMA of observed vs
    ``CapacityTable``-predicted service time (``HealthTracker``); a pod
    whose ratio exceeds ``quarantine_ratio`` is quarantined: excluded
    from dispatch and ``Gateway.route`` exactly like a doomed chip,
    and written off by the capacity model so the next autoscale tick
    replaces it;
  * **SLO-aware admission control** — when the queue is already deeper
    than the function can drain inside the deadline headroom, new
    arrivals are brownout-shed AT ARRIVAL (an explicit fast failure)
    instead of aging out in queue after burning their latency budget.

Both configs are inert by default: a zero-rate ``FaultModel`` and the
default ``ResilienceConfig`` leave the engine byte-identical to a run
with neither attached.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

# Dedicated rng-stream salts, one per fault process (spawned as
# ``default_rng([seed, SALT])`` like the reclaim stream's 0x5EC1A13):
# the processes stay decorrelated from each other, from service noise,
# and from reclaim draws, so enabling one fault kind never perturbs
# another kind's schedule.
CHIP_FAIL_STREAM = 0xFA170C1
STRAGGLER_STREAM = 0xFA170C2
CACHE_LOSS_STREAM = 0xFA170C3
BLACKOUT_STREAM = 0xFA170C4


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Rates and shapes of the four injectable fault processes.

    All rates are Poisson hazards in events/hour — per live chip
    (``chip_failure_rate_per_hour``), per live pod
    (``straggler_rate_per_hour``), per live node
    (``cache_loss_rate_per_hour``), or cluster-global
    (``blackout_rate_per_hour``). A model with every rate at zero is
    inert (``is_active`` False) and the engine skips the chaos paths
    entirely — byte-identical to running with no model at all.
    """
    chip_failure_rate_per_hour: float = 0.0
    straggler_rate_per_hour: float = 0.0
    straggler_factor: float = 4.0      # service-time inflation while slow
    straggler_duration_s: float = 10.0
    cache_loss_rate_per_hour: float = 0.0
    blackout_rate_per_hour: float = 0.0
    blackout_duration_s: float = 5.0

    def __post_init__(self):
        for f in ("chip_failure_rate_per_hour", "straggler_rate_per_hour",
                  "cache_loss_rate_per_hour", "blackout_rate_per_hour"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0")
        if self.straggler_factor < 1.0:
            raise ValueError("straggler_factor must be >= 1 (an inflation)")
        if self.straggler_duration_s <= 0 or self.blackout_duration_s <= 0:
            raise ValueError("fault window durations must be > 0")

    @property
    def is_active(self) -> bool:
        """Whether any fault process has a non-zero rate."""
        return (self.chip_failure_rate_per_hour > 0
                or self.straggler_rate_per_hour > 0
                or self.cache_loss_rate_per_hour > 0
                or self.blackout_rate_per_hour > 0)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Degradation machinery knobs; every mechanism is off by default.

    ``deadline_s`` gives each request an implicit deadline at
    ``arrival + deadline_s``: queued requests past it age out, and a
    killed batch's requests are only retried while they can still make
    it (after ``retry_backoff_s``). ``max_retries`` bounds how many
    times one request may be requeued after kills. A positive
    ``quarantine_ratio`` arms per-pod health scoring; a positive
    ``admission_headroom`` (with a deadline) arms brownout shedding —
    a new arrival is rejected when the queue already needs more than
    ``deadline_s * admission_headroom`` to drain at current capacity.
    """
    deadline_s: float = 0.0            # 0 = no per-request deadline
    max_retries: int = 1               # requeue budget per request
    retry_backoff_s: float = 0.0       # delay before a requeue re-enters
    health_alpha: float = 0.35         # EWMA weight of the newest sample
    quarantine_ratio: float = 0.0      # observed/predicted trip level; 0=off
    quarantine_min_samples: int = 3    # batches before the EWMA is trusted
    quarantine_duration_s: float = 15.0
    admission_headroom: float = 0.0    # deadline fraction the queue may hold

    def __post_init__(self):
        if self.deadline_s < 0 or self.retry_backoff_s < 0:
            raise ValueError("deadline_s / retry_backoff_s must be >= 0")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not (0.0 < self.health_alpha <= 1.0):
            raise ValueError("health_alpha must be in (0, 1]")
        if self.quarantine_ratio < 0 or self.admission_headroom < 0:
            raise ValueError("ratios must be >= 0")
        if self.quarantine_min_samples < 1:
            raise ValueError("quarantine_min_samples must be >= 1")
        if self.quarantine_duration_s <= 0:
            raise ValueError("quarantine_duration_s must be > 0")

    @property
    def quarantine_active(self) -> bool:
        """Whether health scoring + quarantine is armed."""
        return self.quarantine_ratio > 0

    @property
    def admission_active(self) -> bool:
        """Whether brownout admission control is armed (needs a
        deadline to measure headroom against)."""
        return self.admission_headroom > 0 and self.deadline_s > 0

    @property
    def is_active(self) -> bool:
        """Whether any resilience mechanism is armed."""
        return (self.deadline_s > 0 or self.quarantine_active
                or self.admission_headroom > 0)


class HealthTracker:
    """Per-pod EWMA of observed vs predicted service time.

    Fed one sample per dispatched batch (the ratio of the drawn service
    time — noise and any straggler inflation included — to the
    ``CapacityTable`` deterministic prediction). With service noise at
    sigma 0.03 a healthy pod's EWMA hovers at ~1.0; a straggler
    inflating by 3-4x trips any ratio above ~1.5 within
    ``quarantine_min_samples`` batches.
    """

    def __init__(self, cfg: ResilienceConfig):
        """Args: cfg: the run's resilience knobs (alpha/ratio/samples)."""
        self.cfg = cfg
        self._ewma: Dict[str, Tuple[float, int]] = {}  # pod -> (value, n)

    def observe(self, pod_id: str, ratio: float) -> bool:
        """Fold one observed/predicted sample in; True when the pod's
        smoothed ratio now exceeds the quarantine trip level (with at
        least ``quarantine_min_samples`` samples behind it)."""
        a = self.cfg.health_alpha
        v, n = self._ewma.get(pod_id, (1.0, 0))
        v = (1.0 - a) * v + a * ratio
        n += 1
        self._ewma[pod_id] = (v, n)
        return (n >= self.cfg.quarantine_min_samples
                and v > self.cfg.quarantine_ratio)

    def reset(self, pod_id: str) -> None:
        """Forget ``pod_id``'s history (on quarantine entry, so a lifted
        pod starts with a clean score instead of instantly re-tripping)."""
        self._ewma.pop(pod_id, None)

    def score(self, pod_id: str) -> float:
        """The pod's current smoothed observed/predicted ratio."""
        return self._ewma.get(pod_id, (1.0, 0))[0]


class FaultInjector:
    """Owns the four dedicated rng streams and the draw bookkeeping.

    The engine asks for the next event time of each process (in chip /
    pod / node creation order, so schedules are deterministic for a
    given seed and decision history) and schedules the heap events
    itself; ``chip_drawn`` / ``pod_drawn`` / ``node_drawn`` record which
    entities already have a pending draw, mirroring the reclaim path's
    ``_reclaim_scheduled``. Blackout windows are precomputed over the
    whole horizon at construction (the process is cluster-global, so
    nothing about the run can influence it).
    """

    def __init__(self, model: FaultModel, seed: int, horizon_s: float):
        """Args:
            model: the fault processes to drive.
            seed: the run's ``SimConfig.seed`` (streams decorrelate via
                per-process salts).
            horizon_s: draws beyond this are never scheduled.
        """
        self.model = model
        self.horizon_s = float(horizon_s)
        self._chip_rng = np.random.default_rng([seed, CHIP_FAIL_STREAM])
        self._strag_rng = np.random.default_rng([seed, STRAGGLER_STREAM])
        self._cache_rng = np.random.default_rng([seed, CACHE_LOSS_STREAM])
        self._black_rng = np.random.default_rng([seed, BLACKOUT_STREAM])
        self.chip_drawn: set = set()
        self.pod_drawn: set = set()
        self.node_drawn: set = set()
        self.blackouts: List[Tuple[float, float]] = self._draw_blackouts()

    @staticmethod
    def _exp_after(rng: np.random.Generator, rate_per_hour: float,
                   t: float) -> float:
        return t + float(rng.exponential(3600.0 / rate_per_hour))

    def draw_chip_failure(self, t: float) -> float:
        """Next hard-failure time of a chip first seen live at ``t``."""
        return self._exp_after(self._chip_rng,
                               self.model.chip_failure_rate_per_hour, t)

    def draw_straggler(self, t: float) -> float:
        """Next straggler-window start for a pod, drawn from ``t``
        (first sight or the end of its previous window)."""
        return self._exp_after(self._strag_rng,
                               self.model.straggler_rate_per_hour, t)

    def draw_cache_loss(self, t: float) -> float:
        """Next host-cache-loss time for a node, drawn from ``t``."""
        return self._exp_after(self._cache_rng,
                               self.model.cache_loss_rate_per_hour, t)

    def _draw_blackouts(self) -> List[Tuple[float, float]]:
        m = self.model
        if m.blackout_rate_per_hour <= 0:
            return []
        out, t = [], 0.0
        while True:
            t = self._exp_after(self._black_rng, m.blackout_rate_per_hour, t)
            if t > self.horizon_s:
                return out
            out.append((t, t + m.blackout_duration_s))
            t += m.blackout_duration_s   # windows never overlap

    def in_blackout(self, t: float) -> bool:
        """Whether the control plane is blacked out at ``t``."""
        for a, b in self.blackouts:
            if t < a:
                return False
            if t < b:
                return True
        return False
